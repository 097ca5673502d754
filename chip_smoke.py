#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env     — the card (nvidia-smi name and power limit), torch and CUDA
             versions; TF32 off for the whole run.
2. build   — compiles the five sources simpb_tpu_torch/csrc/{assignment,
             conv_fused,conv_tc,mosaic_probe,sampling}.cu with nvcc for
             sm_90a, one nvcc each, all started together; prints each
             kernel instance's registers and spills (-Xptxas -v) and
             fails if an assignment, sampling or max-pool instance
             spills.
3. kernels — each trunk kernel (K1 max-pool, K2 downsample bottleneck,
             K3 bottleneck, K4 3x3 conv) against its plain PyTorch
             version at every full-width shape of the main path and of
             an r101 frame (`simpb_r101_1408x512`: ResNet-101 at
             1408x512, six images; summed a frame apart), at the
             tiny config's smallest maps and, for K1, at odd H and W and
             at channels that take no 16-byte packs, fp32 and bf16 (bf16
             K2-K4 are the tensor-core kernels of conv_tc.cu, fp32 the
             CUDA-core ones of conv_fused.cu; K1 must equal its plain
             version bit for bit); each call launched twice (the outputs
             must be bit-identical), with its time (CUDA events, warm:
             `ms` through the wrapper back to back, `device_ms` queued
             behind a spin kernel), the plain version's, the cuDNN call
             computing the same function where one exists (timed only),
             for K2 and K3 the unfused cuDNN chain of their convs with
             bias, ReLU and the residual add (`cudnn_chain_ms`, timed
             only), and the least time the card could take (bytes over
             3.35 TB/s or operations over the peak rate of the type,
             published H100 SXM figures).
4. probes  — the probe tool's path (`simpb_tpu_torch.tools.mosaic_probe`,
             the Hopper counterparts of tools/mosaic_probe.py) with the
             launch counts set to 0 before it and read after; then each
             probe kernel against its plain version (bf16 through fp32 is
             a copy: exactly equal), timed beside its plain version and
             the one strided-copy call computing the same function.
5. slice   — the main path: `simpb_r50_704x256_fast` as bench.py serves
             it (trunk and head bf16) with the fused trunk at full width
             (ResNet-50, 704x256, 6 cameras, 900 anchors, 600 temporal
             instances), seeded random weights; one cold frame and
             FRAMES (8) stream frames, the launch counts set to 0 just
             before and read just after; before it the same with the
             head in fp32, FP32_HEAD_FRAMES (3) stream frames. Launch
             counts must be K1 1, K2 4, K3 12, K4 4, DFA 3 and MSDA-sel 3
             per frame. Prints each frame's ms, their median and range, the
             trunk's ms alone and the peak device memory. The arguments
             of every sampling call of the main path's last stream frame
             are recorded.
6. sampling — the DFA and windowed-MSDA kernels against their plain
             versions, each call launched twice (the two outputs must be
             bit-identical): (a) on the recorded calls of that stream
             frame, in the main path's dtypes; (b) on synthetic cases in
             fp32 and bf16 (more in-range DFA slots than the capacity,
             locations at and beyond the borders, anchors with no live
             entry and with all 312 live; MSDA samples spread past the
             window, queries with every sample dropped, tied level
             masses, window mids on rounding ties, windows flush with a
             level's border and at 0, an odd query count, the tiny
             config's widths: C 64, 4 heads).
             Timed through the wrapper back to back (`ms`), on the
             device alone (`device_ms`: the calls queued behind a spin
             kernel, so the host's time drops out) and
             beside the plain version, with the bound from the rows the
             call gathers.
7. parity  — one cold frame of the slice through the kernels and through
             their plain versions (trunk and sampling): in fp32 the head
             outputs compared directly; with trunk and head in bf16 both
             routes held against the fp32 plain route.
8. trunk   — ResNet-50 + FPN at the main path's input in bf16, once
             through the kernels and once through their plain versions,
             each held against the fp32 plain trunk per FPN level; the
             stem timed as it runs and, as a yardstick, as the bf16 conv
             it replaced.
8a. r101  — both ResNet-101 configs at 1408x512 as `python -m
             simpb_tpu_torch.tools.test --config r101|r101-fast
             --head-bf16` serves them (trunk and head bf16, bs 1): a
             cold frame and FRAMES stream frames each, the launch counts
             set to 0 just before and read just after; every frame's
             launches must be R101_LAUNCHES' (`simpb_r101_1408x512` on
             the fused trunk: K1 1, K2 4, K3 29, K4 4, DFA 3, exact MSDA
             3; `simpb_r101_1408x512_fast`, `stem_s2d`, on the module
             trunk by JAX's rule: K1 1, DFA 3, MSDA-sel 3), then day
             0's demand pass at r101 (`tools/day0.py --config r101`'s
             config: the hybrid on the fused trunk at a capacity of
             every entry, guards on, head fp32; K1-K4 as r101's, DFA 3,
             H1 3, H2 3, H3 6); the stream's checks; frame ms, median
             and range, trunk ms, peak memory. Then H1-H3 against their
             plain versions on the demand pass's last-frame calls at
             the 59,840-row column, as phase 11 holds them (H3 beside
             its chains, H1 at each stage count).
8b. trunk_r101 — phase 8 for the r101 fused trunk, and on the same
             weights the module trunk with the s2d stem: through K1
             equal to its plain route bit for bit, in fp32 and bf16
             within MODULE_TRUNK_FP32_REL / MODULE_TRUNK_BF16_REL of the
             fp32 fused trunk; the stems timed.
9. eval    — the evaluation path as `python -m simpb_tpu_torch.tools.test
             --config r50-fast --head-bf16 --tracking` runs it, on a
             synthetic nuScenes-format infos pkl (EVAL_FRAMES frames of
             six 1600x900 cameras in two scenes split by a 10 s gap, a
             rig that puts the objects in view): `streaming_eval` with
             both scorers, the launch counts set to 0 just before and
             read just after. Only the image decode is replaced: a
             dataset subclass serves seeded uint8 frames from memory (the
             card's machine has no Pillow), and everything after it runs:
             geometry, the native preprocess, projections, annotations,
             the stream steps and decode, boxes to the global frame, the
             scorers. Checks the native path was taken, 1/4/12/4/3/3
             launches every frame, the scene ids split at the gap, JAX's
             metric keys, and each frame's decode bit for bit against a
             `make_stream_steps` rerun over the same samples; prints the
             median host ms of `get_sample`, the median frame ms (step,
             decode and the one `.cpu()`) and the metrics (near zero with
             random weights: the phase shows that the path runs).
10. bench  — `simpb_tpu_torch.bench`'s served config through
             `run_benchmark` with a window of BENCH_WINDOW frames, the
             launch counts set to 0 just before and read just after;
             prints the bench's JSON line; fps > 0 and a peak are set.
             Then the same under SIMPB_FUSED_TRUNK=0, on the module
             trunk (launches K1 1, DFA 3, MSDA-sel 3 a frame).
10a. profile — `python -m simpb_tpu_torch.tools.profile` (JAX's
             profiled frame, `simpb_r50_704x256` trunk bf16: K1, DFA,
             exact MSDA) over PROFILE_FRAMES frames and with `--train`
             (`tools/train.py --config r50`, bs 4) over PROFILE_STEPS
             steps: its table, total device ms, window ms and idle share;
             the launches its trace counts equal the wrappers' counters
             and the frame's and step's launches.
10b. tools_bench — `python -m simpb_tpu_torch.tools.benchmark --config
             r50-fast` (JAX's tool: the module trunk, bf16): its JSON
             line; K1 1, DFA 3, MSDA-sel 3 a frame.
10c. export — `python -m simpb_tpu_torch.tools.export --config r50-fast
             --fused-trunk --smoke`: the export's seconds and the
             artifact's bytes; then EXPORT_FRAMES frames through the
             loaded artifact, bit for bit the model's, every plain
             version refused while it runs, 1/4/12/4/3/3 launches a frame.
10d. encoder2d — the flagship with one encoder layer, unshared (the
             decoupled attention on) and shared (off): ENCODER_FRAMES
             frames each, launches 1/4/12/4/3/3 and 1 exact MSDA a frame,
             each frame's outputs through the kernels and the plain route
             against the fp32 plain route (the parity phase's rule); then
             the exact MSDA kernel and kernel D on the encoder's call
             ([6, 14,960, 256] values) against `msda_plain` (EXACT_TOL)
             and the chunked plain gradients (GRAD_TOL), in bf16 and fp32,
             repeats bit-identical; the kernels line's `msda` and
             `msda_backward` rows gain an `encoder2d` entry.
11. exact  — the exact-sampling serving path. (a) Frames: the configs
             the bench serves under SIMPB_EXACT (`simpb_r50_704x256`:
             exact MSDA, no slot capacity, DFA capacity 4096),
             SIMPB_GUARDED (`_guarded`: exact MSDA, capacities 208 and
             2304, guard counters) and SIMPB_FAST_GUARDED
             (`_fast_guarded`: the flagship and its counters, windowed
             ones among them) and SIMPB_HYBRID (`_hybrid`: windowed MSDA
             over every level with an exact correction lane of 256
             entries a camera, capacities 208 and 2304, guard counters),
             trunk and head bf16: a cold frame and FRAMES stream frames
             each, the launch counts set to 0 just before and read just
             after; 1/4/12/4/3 trunk and DFA launches a frame, and 3 of
             exact MSDA (0 of MSDA-sel), or the reverse for
             `_fast_guarded`, or for the hybrid H1 3, H2 3 and H3 6 (3 of
             the op's instance, 3 of the guards') and neither MSDA-sel
             nor exact MSDA; finite, sorted decodes; frame ms, peak
             memory, and each guard counter's maximum (the hybrid's
             `msda_clamp_demand` and `msda_clamp_overflow` among them);
             for the hybrid, the CUDA kernels one more stream frame
             launches, counted from torch.profiler's kernel events
             (`frame_kernels`).
             The last frame's sampling calls are recorded. (b) Kernels:
             the exact MSDA kernel against `msda_plain` within EXACT_TOL, and DFA
             at capacities 4096 and 2304 against its plain version, on
             the recorded calls and on synthetic full-width cases in fp32
             and bf16 (Q 256 and 208, locations at and past every
             border, all-zero locations, 207 queries, the tiny widths),
             each launched twice (bit-identical), timed as in phase 6,
             exact MSDA beside the grid_sample chain (mmcv's plain
             formulation, one `F.grid_sample` a level and the weighted
             sum; timed, and held to `msda_plain` in fp32 once); on one
             recorded call the kernel is timed beside its probes (one
             sample's rows in flight instead of two, its loads alone,
             its arithmetic alone: what bounds it). (b') The hybrid's
             kernels: H1 (`_msda_patch_levels`: bf16 the ring of
             per-level windows, `msda_levels_tc_kernel`, in the hybrid's
             layout and once in msda_patch's; fp32 MSDA-sel's CUDA-core
             kernel with every level) within SAMPLING_TOL's fp32 share,
             H2 (`msda_hybrid_exact`: `msda_hybrid_kernel`, the exact
             lane added in place)
             within EXACT_TOL and H3's two instances bit for bit (the
             op's `hybrid_selection`: mask and zeroed weights; the
             guards' `msda_clamp_demand`: counts) against their plain
             versions, on the hybrid frame's recorded calls and on
             synthetic full-width cases in fp32 and bf16 (demand under,
             at and over the capacity, a tie on its boundary, samples
             past the windows and at and beyond the borders, padded
             slots among the corrected entries, the guards' 256 slots
             with padded and invalid ones, 207 queries; for H2 also a
             sparse lane, about 5 % of a row's entries corrected), each
             launched twice (bit-identical), timed as in phase 6 (H2 in
             place), H2 beside the grid_sample chain over its entries,
             with each case's corrected entries and marked queries
             (`exact_lane` lines) and, on one frame call, its probes
             (no entry marked; every entry marked, with the frame's
             samples, with every sample at one point and spread over the
             levels: what sets its time), each
             H3 instance and the sparse H2 case beside one empty launch
             (its latency floor);
             `msda_hybrid` on the card
             against `msda_hybrid_plain` at demand under, at and over the
             capacity and at a tie on its boundary (the corrected entries
             equal); and on the recorded calls, at a capacity of every
             entry, against the exact MSDA kernel in bf16 and fp32 (the
             largest error printed, held at HYBRID_EXACT_TOL). (c) The
             eval CLI: `tools/test.py --config r50-guarded --tracking`,
             then `--config r50-hybrid --tracking`, through its `main`
             over a synthetic 1600x900 pkl of EXACT_CLI_FRAMES frames
             (decoded frames served from memory), launches counted; it
             prints the guard maxima and must exit 3 exactly when one is
             nonzero (with random weights the hybrid's correction lane,
             like the slot and DFA capacities, overflows: exit 3, taken
             only with guard_msda_clamp_overflow > 0). (d)
             The bench's lines under SIMPB_HYBRID and SIMPB_HYBRID with
             SIMPB_CLAMP_CAP=832 (`run_benchmark`, a BENCH_WINDOW-frame
             window, launches counted).
12. train  — the training step of `simpb_r50_704x256_fast` as
             tools/train.py trains it (trunk bf16 with remat, head fp32,
             grid mask and dropout on, `TrainConfig()`), at full width
             and bs TRAIN_BS (4) x 6 cameras, seeded random weights and a
             synthetic batch (`utils/synthetic.py::synthetic_train_batch`:
             24 objects in view a sample, GT padded to 128 3D and 64 2D
             boxes, sparse depth maps): one warm step, then TRAIN_STEPS
             (4) steps carrying the temporal and DN state, the launch
             counts set to 0 just before and read just after. Checks a
             finite loss and the complete key set every step, launches a
             step (K1-K4 none; DFA and MSDA-sel forward and backward 3
             each; the assignment 3: all six refine3d layers' matrices in
             one call, all three refine2d layers' in one, the DN
             anchors'), parameters moved and the frozen
             instance feature not; prints step ms (host clock ending in
             `synchronize`), forward / backward / optimizer ms (CUDA
             events) and the peak memory. The last step's kernel calls
             are recorded.
13. train kernels — kernels B (DFA backward) and C (MSDA-sel backward)
             against their plain versions (fp32 sums of the forward's
             rounded quantities) on the recorded calls and on phase 6's
             synthetic cases with a random output gradient, each
             launched twice (the repeats must be bit-identical: neither
             has atomics), B's three launches (B0, B1, B2) also timed
             apart on the device; kernel
             A (the assignment) on every recorded call against its plain
             version on the CPU (exact `col4row` on every row, padded
             rows too) and scipy's optimal cost (1e-5 relative), launched
             twice (bit-identical), with scipy's host time, the serial
             Dijkstra steps of each call's longest matrix (counted by the
             plain version) and the latency floor they set: steps times
             one link of a chain of dependent warp argmins, timed on the
             card by a one-warp kernel.
14. train_exact — phase 12 for `simpb_r50_704x256` as `tools/train.py
             --config r50` (the trainer's default) trains it: exact MSDA,
             no slot capacity, DFA capacity 4096. Launches a step: K1-K4
             none; DFA, B, exact MSDA and D (its backward) 3 each; MSDA-sel
             and C none; the assignment 3. Then kernel D against
             `msda_backward_plain` (autograd through `msda_plain`: fp32
             sums, the value gradient rounded once) element by element
             at GRAD_TOL on the last step's recorded calls and on the
             exact phase's synthetic cases in fp32 and bf16 with random
             sampled and wsum gradients, each launched twice
             (bit-identical: no atomics), its launches timed apart on
             the device (D1, the bin pass, D2 over the tiles that fit a
             chunk and over the crowded ones, and D2 over each level's
             tiles and over its tile (0, 0) alone), beside the
             grid_sample chain's backward (timed only).
14a. train_r101 — phase 12 for `simpb_r101_1408x512_fast` as
             `tools/train.py --config r101-fast` trains it (the module
             trunk in training with the s2d stem, remat), a warm step
             and R101_TRAIN_STEPS (2) more at the trainer's bs 4 (out
             of memory fails the run): finite losses, the launches a
             step (DFA, MSDA-sel, B, C 3 each, A 3), peak memory. Then
             train_r101_exact: phase 12 for `simpb_r101_1408x512`
             (`--config r101`, exact MSDA), a warm step and one more
             (DFA, B, exact MSDA, D 3 each, A 3), and kernel D against
             `msda_backward_plain` on that step's recorded calls, as
             phase 14 holds it.
15. train_cli — the training CLI (`python -m simpb_tpu_torch.tools.train
             --config r50-fast --batch-size 4`, trunk bf16, head fp32)
             through `tools/train.py::run`, TRAIN_CLI_ITERS (6) iterations
             with a checkpoint every TRAIN_CLI_CKPT (3) and a log line
             every one, over a synthetic training pkl
             (`write_synthetic_infos`: TRAIN_CLI_FRAMES (24) frames of six
             1600x900 cameras in two scenes, 2D GT and LiDAR files) and
             a mid-training eval with `ckpt_best` at iteration 6 over a
             12-frame val pkl; decoded frames served from memory by a
             dataset subclass (no Pillow), everything after the decode
             run as the CLI runs it (sampler, native preprocess,
             photometric jitter, 2D GT, depth maps, 3D augmentation,
             `pad_sample`, the producer thread). Then a second run
             resumed from `ckpt_3` to iteration 6. The launch counts are
             set to 0 before the first run and read after; each step's
             launches must be want_train_launches (0 trunk, 3 each of
             DFA, MSDA-sel, B, C and A), the eval's 1/4/12/4/3/3 a frame.
             Checks the native route on every sample, finite losses with
             the full key set, ckpt_3, ckpt_6 and ckpt_best written,
             `ckpt_best` read back into fresh templates equal to the
             run's final state bit for bit (parameters, BN buffers,
             moments, step, temporal and DN state, poses, best score),
             the resumed run's batches 4-6 equal the first run's bit for
             bit (sha256 of every array on the host, before the card),
             and step 4's loss within TRAIN_CLI_LOSS_RTOL of the first
             run's. Prints the step ms (host clock; each log line
             synchronises), the producer's ms a batch, the ms the loop
             waited on the queue a step, checkpoint ms and bytes, the
             restore's ms, the peak memory and the eval's ms a frame.
16. train_cli_exact — the training CLI's default, `--config r50
             --batch-size 4` (exact MSDA), through `run` for
             TRAIN_CLI_EXACT_ITERS (3) iterations over the same synthetic
             training pkl, no eval: each step's launches (as phase 14's),
             finite losses with the full key set, the final checkpoint.
17. train_ddp — data-parallel training over torch.distributed, in
             DDP_WORLD (2) spawned processes at bs 2 each on rows 2r, 2r+1
             of a bs-4 batch, both on cuda:0 over gloo (set up here: NCCL
             refuses two ranks on one device), against this process at
             bs 4. The parity run (parity_config(): `simpb_tiny` with the
             flagship's fast knobs, ResNet-50 trunk in float64, head fp32, at
             DDP_PARITY_LR; at full width the random-weight step is
             chaotic, see `spread` below): a rank takes the one process's
             assignments (nearest cost matrix) and, from step 2, its
             carried temporal and DN state (random weights put predictions
             within a rounding of a tie); step 1's reduced gradients
             against the one process's element by element, head and trunk
             apart (the relative L2 norm of the difference over each group
             within DDP_GRAD_REL_L2; the worst element printed), the global
             losses of DDP_STEPS (3) steps within DDP_LOSS_RTOL, launches
             PARITY_LAUNCHES a step. The timed run: the flagship as the
             CLI trains it (trunk bf16, head fp32, `TrainConfig()`), 3
             steps a rank, launches 0 trunk and 3 each of DFA, B, MSDA-sel,
             C and A a step, step ms and peak bytes a rank. In both the
             ranks' parameters, BatchNorm statistics and Adam moments are
             bit-identical (sha256) and the backend is gloo. `spread`:
             the flagship's step 1 here at bs 4 twice, as it is and with
             every BatchNorm mean moved by two fp32 ulps, beside the timed
             run's step 1 at world 2 (printed, not held). Then
             `tools/train.py::main --multihost --coordinator
             127.0.0.1:<port> --num-processes 1 --process-id 0` for
             NCCL_ITERS (2) iterations in a spawned process: NCCL at world
             1, every collective through it (and at world 2, one card a
             rank, when the machine has two cards).
18. eval_dist — `distributed_streaming_eval` in train_ddp's two
             processes (gloo) over the eval phase's 12-frame set, one
             scene a rank, gathered on disk: rank 0's metrics and every
             prediction equal to this process streaming the same two
             shards; 1/4/12/4/3/3 launches a frame on each rank.
19. eval_multi — `multidevice_streaming_eval(devices=["cuda:0"] * 4)`,
             the flagship as bench.py serves it, over four scenes of four
             frames: bs 4 on one card against `streaming_eval` of each
             shard at bs 1. The first decoder layer's outputs (no temporal
             input yet) of every frame and slot within MULTI_TOL of their
             largest value, each frame's valid instance ids equal, frames
             shard-major, launches 1/4/12/4/3/3 a step (not a slot); ms a
             step and frames a second at bs 4 and bs 1.
             The kernels are built once, before any process starts; each
             of these phases' seconds is printed.

Then the run's seconds, the kernels' summary line, the card line, and
as the last line
{"ok": true, "device": {...}}. Any failure raises (exit code != 0). With
no CUDA device, or outside the repository, it exits 2 and prints no
result.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, per second
# per-call error bound, relative to max |plain| (at least 1): fp32 sums
# run in another order than cuDNN's; bf16 intermediates (y1, y2) round
# to the storage type, where one ulp is 2^-8 of the value
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# whole-slice fp32 parity (kernels vs plain versions): sum order through
# 16 blocks and 6 decoder layers; the CPU parity of the tiny slice with
# the JAX package holds 5e-4 (tests/test_torch_port_slice.py)
SLICE_ATOL, SLICE_RTOL = 2e-3, 2e-3
# sampling kernels against their plain versions, relative to max(|plain|,
# 1). fp32: every sample is bit-identical (explicit roundings, no FMA
# contraction), only the fp32 sums run in another order. bf16 DFA: every
# bf16 rounding is the plain version's too, so again only the order of
# the fp32 sums of up to cams * points * levels weighted samples differs
# (<= 312 * 2^-24 of the sum of their magnitudes); 1e-3 leaves room for
# that and stays far below the ~0.37 that fp32 position arithmetic gives.
# MSDA computes in fp32 whatever the value dtype.
SAMPLING_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
FRAMES = 8  # stream frames after the cold frame (bf16 head)
# the exact phase's configs: the bench's switches, in bench.py's order,
# then the hybrid
EXACT_SWITCHES = ("SIMPB_EXACT", "SIMPB_GUARDED", "SIMPB_FAST_GUARDED",
                  "SIMPB_HYBRID")
EXACT_CLI_FRAMES = 6  # the eval CLI's frames under r50-guarded, r50-hybrid
# exact MSDA against msda_plain, relative to max(|plain|, 1): every
# bilinear sample rounds as the plain version's in both value types (the
# corner weights, the x pairs and the y combine in the value's type), so
# only the order of the fp32 sums of 16 weighted samples a head differs
EXACT_TOL = {"float32": 1e-5, "bfloat16": 1e-5}
FP32_HEAD_FRAMES = 3  # the same with the head in fp32
EVAL_FRAMES = 12  # two scenes of six frames
BENCH_WINDOW = 32  # frames a window (one warm, one timed)
# launches a frame on the main path
WANT_LAUNCHES = {"maxpool_3x3_s2": 1, "bottleneck_down": 4, "bottleneck": 12,
                 "conv3x3_bias": 4, "deformable_aggregation": 3,
                 "msda_patch_sel": 3}
# whole-slice bf16 parity (trunk and head in bf16, one cold frame): both
# bf16 routes round at the same points, so each is as far from the fp32
# route as the other, up to roundings flipped by the fp32 sums' order,
# which compound through the trunk and six decoder layers: the kernels'
# relative L2 error may be 1.5 times the plain route's, plus a floor of
# one bf16 ulp (2^-8)
BF16_SLICE_RATIO, BF16_SLICE_FLOOR = 1.5, 4e-3
SOURCES = ("assignment", "conv_fused", "conv_tc", "mosaic_probe", "sampling")
# the source of each trunk kernel on the main path (bf16)
TRUNK_SOURCE = {"maxpool_3x3_s2": "conv_fused", "bottleneck_down": "conv_tc",
                "bottleneck": "conv_tc", "conv3x3_bias": "conv_tc"}
# bf16 trunk check: per FPN level, the kernels' relative L2 error
# against the fp32 plain trunk may be at most TRUNK_RATIO times the plain
# bf16 route's plus TRUNK_FLOOR. Both bf16 routes round the same
# intermediates at the same points, so their errors are both the bf16
# rounding of the activations; only the fp32 sums run in another order,
# which flips a rounding now and then, and such flips compound through
# 16 blocks and the FPN: 1.5 leaves room for that. The floor, a tenth of
# a bf16 ulp (2^-8), covers a level whose plain error happens to be small.
TRUNK_RATIO, TRUNK_FLOOR = 1.5, 4e-4



def resnet_stages(w, h, blocks):
    """(mid channels, out channels, output H, W, stride of the stage head,
    blocks) of each ResNet stage at a W x H input."""
    return tuple((64 << i, 256 << i, h // (4 << i), w // (4 << i),
                  1 if i == 0 else 2, n) for i, n in enumerate(blocks))


# ResNet-50 at 704x256 (the main path) and ResNet-101 at 1408x512
STAGES = resnet_stages(704, 256, (3, 4, 6, 3))
R101_STAGES = resnet_stages(1408, 512, (3, 4, 23, 3))
# the r101 phase: the eval CLI's `--config` names, and each one's launches
# a frame as the CLI serves it (`--head-bf16`): simpb_r101_1408x512 on the
# fused trunk with exact MSDA; simpb_r101_1408x512_fast (stem_s2d) on the
# module trunk, whose only kernel is K1, with MSDA-sel
R101_TRUNK = {"maxpool_3x3_s2": 1, "bottleneck_down": 4, "bottleneck": 29,
              "conv3x3_bias": 4}
R101_LAUNCHES = {
    "r101": {**R101_TRUNK, "deformable_aggregation": 3, "msda": 3},
    "r101-fast": {"maxpool_3x3_s2": 1, "deformable_aggregation": 3,
                  "msda_patch_sel": 3},
    # day 0's demand pass at r101 (`tools/day0.py --config r101`): the
    # hybrid on the fused trunk, guards on, so H3 twice a layer
    "day0-r101": {**R101_TRUNK, "deformable_aggregation": 3,
                  "msda_patch_levels": 3, "msda_hybrid_exact": 3,
                  "clamp_select": 3, "clamp_demand": 3}}
R101_TRAIN_STEPS = 2  # r101-fast training steps after the warm step
# the module trunk in bf16 against the fused trunk in fp32 (same weights,
# r101), relative L2 per FPN level: the module route rounds every conv's
# output to bf16 before its BatchNorm and every BatchNorm's output after,
# some 200 roundings on an activation's way through 33 blocks and the
# FPN. Measured 0.0109 (level 2) to 0.0123 (level 0) on the H100; 0.03
# is 2.4 times the largest, and a BatchNorm computed in bf16 or a
# rounding point moved shows as several percent
MODULE_TRUNK_BF16_REL = 0.03
# the module trunk in fp32 against the fused trunk in fp32: the same
# function (BatchNorm unfolded, the stem's s2d sum) in other fp32 orders
MODULE_TRUNK_FP32_REL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_summary(log: str):
    """One line per kernel instance of an `nvcc -Xptxas -v` report:
    its name with the template's integer arguments, registers, stack
    and spills."""

    def demangle(sym):
        # the length-prefixed source name ending in _kernel, then the
        # integer template arguments that follow it
        for m in re.finditer(r"(?=\d{1,3}[A-Za-z_])", sym):
            for k in (3, 2, 1):
                digits = sym[m.start():m.start() + k]
                rest = sym[m.start() + k:]
                if digits.isdigit() and rest[int(digits) - 7:int(digits)] \
                        == "_kernel":
                    tail = rest[int(digits):].split("EEv")[0]
                    args = (["bf16"] if "bfloat16" in tail else
                            ["f32"] if tail.startswith("If")
                            or "PackIf" in tail else []) \
                        + re.findall(r"L[ib](\d+)E", tail)
                    return rest[:int(digits)] + (
                        f"<{','.join(args)}>" if args else "")
        return sym

    out, name = [], "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = demangle(m.group(1))
        elif "spill" in ln:
            out.append(f"{name}: {ln.strip()}")
        elif "registers" in ln:
            out[-1:] = [f"{out[-1]}; {ln.split(':', 1)[1].strip()}"] \
                if out and out[-1].startswith(name) else \
                [*out, f"{name}: {ln.split(':', 1)[1].strip()}"]
    return out


def free_cuda(torch) -> None:
    """Return the memory of deleted models to the card: a model's
    load-state-dict hook is a bound method, a cycle that only the
    cyclic collector frees, and an unfreed model sits in the next
    phase's peak memory."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def cuda_ms(fn, iters: int = 10) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of `fn`, without the host's: the events
    bracket `iters` calls queued behind `torch.cuda._sleep`, long enough
    that the host has enqueued them all before the first starts (checked:
    the start event must still be pending when the host is done; else
    the spin doubles). `cuda_ms` times the same calls back to back, so
    where a call's host time exceeds its device time it measures the
    host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(host_s, 1e-3) * 4e9)  # ~2x the host time at <= 2 GHz
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise AssertionError("device_ms: the spin never covered the enqueueing")


def frame_cases(stages):
    """(name, calls per frame, shapes) of every distinct call of a bs-1
    frame's fused trunk (six images) over `stages`."""
    h0, w0 = stages[0][2:4]
    cases = [("maxpool_3x3_s2", 1, dict(x=(6, 2 * h0, 2 * w0, 64)))]
    cin = 64
    for cm, co, h, w, s, n in stages:
        hin, win = h * s, w * s
        cases.append(("bottleneck_down", 1, dict(
            x=(6, hin, win, cin), c=cin, cm=cm, co=co, stride=s)))
        cases.append(("bottleneck", n - 1, dict(
            x=(6, h, w, co), c=co, cm=cm, co=co, stride=1)))
        cases.append(("conv3x3_bias", 1, dict(x=(6, h, w, 256), c=256,
                                              co=256)))
        cin = co
    return cases


def kernel_cases():
    """(name, calls per frame, shapes) for every distinct full-width
    call of the main path, an odd-sized max-pool, one whose channels
    take no 16-byte packs, and the tiny config's smallest maps (no call
    a frame)."""
    cases = frame_cases(STAGES)
    cases[1:1] = [("maxpool_3x3_s2", 0, dict(x=(6, 127, 351, 64))),
                  ("maxpool_3x3_s2", 0, dict(x=(2, 33, 47, 30)))]
    # no call a frame: the stage heads and the last two stages of
    # simpb_tiny (64x32 input), maps smaller than one tile
    cin, hin, win = 64, 8, 16
    for cm, co, _, _, s, _ in STAGES:
        cases.append(("bottleneck_down", 0, dict(
            x=(6, hin, win, cin), c=cin, cm=cm, co=co, stride=s)))
        cin, hin, win = co, hin // s, win // s
    cases += [("bottleneck", 0, dict(x=(6, 2, 4, 1024), c=1024, cm=256,
                                     co=1024, stride=1)),
              ("bottleneck", 0, dict(x=(6, 1, 2, 2048), c=2048, cm=512,
                                     co=2048, stride=1)),
              ("conv3x3_bias", 0, dict(x=(6, 1, 2, 256), c=256, co=256))]
    return cases


def make_inputs(case, dtype, gen):
    import torch

    dev = "cuda"
    rnd = lambda *s, scale=1.0: torch.randn(
        *s, generator=gen, device=dev) * scale
    name, _, a = case
    x = rnd(*a["x"]).to(dtype).contiguous()
    if name == "maxpool_3x3_s2":
        return (x,)
    if name == "conv3x3_bias":
        c, co = a["c"], a["co"]
        return (x, rnd(3, 3, c, co, scale=(9 * c) ** -0.5), rnd(co) * 0.1)
    c, cm, co = a["c"], a["cm"], a["co"]
    folded = (rnd(c, cm, scale=c ** -0.5), rnd(cm) * 0.1,
              rnd(3, 3, cm, cm, scale=(9 * cm) ** -0.5), rnd(cm) * 0.1,
              rnd(cm, co, scale=cm ** -0.5), rnd(co) * 0.1)
    folded = tuple(t.to(dtype) if t.dim() > 1 else t for t in folded)
    if name == "bottleneck":
        return (x, folded)
    down = (rnd(c, co, scale=c ** -0.5).to(dtype), rnd(co) * 0.1)
    return (x, folded, down, a["stride"])


def work(case, itemsize):
    """(bytes, operations) the call must move and do at least: each
    input read once, each output written once."""
    name, _, a = case
    b, h, w, c = a["x"]
    if name == "maxpool_3x3_s2":
        n_out = b * ((h + 1) // 2) * ((w + 1) // 2) * c
        return (b * h * w * c + n_out) * itemsize, 8 * n_out
    if name == "conv3x3_bias":
        co = a["co"]
        macs = b * h * w * 9 * c * co
        byts = (b * h * w * (c + co) + 9 * c * co) * itemsize + 4 * co
        return byts, 2 * macs
    cm, co, s = a["cm"], a["co"], a["stride"]
    oh, ow = h // s, w // s
    macs = b * (h * w * c * cm + oh * ow * (9 * cm * cm + cm * co))
    wts = c * cm + 9 * cm * cm + cm * co
    if name == "bottleneck_down":
        macs += b * oh * ow * c * co
        wts += c * co
    byts = (b * h * w * c + b * oh * ow * co + wts) * itemsize \
        + 4 * (2 * cm + 2 * co)
    return byts, 2 * macs


def library_call(case, args):
    """The one PyTorch call computing the same function (cuDNN), timed
    as a yardstick only; None where no single call does."""
    import torch.nn.functional as F

    name = case[0]
    if name == "maxpool_3x3_s2":
        x = args[0].permute(0, 3, 1, 2)
        return lambda: F.max_pool2d(x, 3, 2, 1)
    if name == "conv3x3_bias":
        x, k, bias = args
        xc = x.permute(0, 3, 1, 2)
        wc = k.to(x.dtype).permute(3, 2, 0, 1).contiguous()
        bc = bias.to(x.dtype)
        return lambda: F.conv2d(xc, wc, bc, padding=1)
    return None


def cudnn_chain(case, args):
    """K3's or K2's function as the unfused cuDNN chain, timed as a
    yardstick only: bf16 convs with bias (reduce, 3x3 at the stride,
    expansion; K2's strided 1x1 skip), ReLU, the residual add. None for
    the other kernels."""
    import torch
    import torch.nn.functional as F

    if case[0] not in ("bottleneck", "bottleneck_down"):
        return None
    x, (w1, b1, w2, b2, w3, b3) = args[:2]
    cl = torch.channels_last
    as_1x1 = lambda w: w.t()[:, :, None, None].contiguous(memory_format=cl)
    xc = x.permute(0, 3, 1, 2)
    w1c, w3c = as_1x1(w1), as_1x1(w3)
    w2c = w2.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    b1c, b2c, b3c = (t.to(x.dtype) for t in (b1, b2, b3))
    if case[0] == "bottleneck":
        s, skip = 1, lambda: xc
    else:
        (wd, bd), s = args[2:]
        wdc, bdc = as_1x1(wd), bd.to(x.dtype)
        skip = lambda: F.conv2d(xc, wdc, bdc, stride=s)

    def chain():
        y = torch.relu(F.conv2d(xc, w1c, b1c))
        y = torch.relu(F.conv2d(y, w2c, b2c, stride=s, padding=1))
        return torch.relu(F.conv2d(y, w3c, b3c) + skip())
    return chain


def phase_kernels(torch, conv_fused):
    """The trunk kernels against their plain versions at the main path's
    shapes (r50 at 704x256) and at simpb_r101_1408x512's; returns the
    per-frame sums of each (`summary` for the main path, `summary_r101`
    for an r101 frame) and the wrappers."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    wrappers = {n: (w, p, tpu) for n, w, p, tpu in conv_fused.KERNELS}
    # per kernel, over a frame's calls at bf16 (the frame's type);
    # `bound` sums each call's bound by what bounds that call
    new = lambda: {n: dict(max_abs_err=0.0, ms=0.0, device_ms=0.0,
                           plain_ms=0.0, library_ms=0.0, cudnn_chain_ms=0.0,
                           bound={"bytes": 0.0, "operations": 0.0})
                   for n in wrappers}
    summary, summary_r101 = new(), new()
    for config, case, summ in (
            [("simpb_r50_704x256_fast", c, summary) for c in kernel_cases()]
            + [("simpb_r101_1408x512", c, summary_r101)
               for c in frame_cases(R101_STAGES)]):
        name, count, a = case
        wrapper, plain, _ = wrappers[name]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            args = make_inputs(case, dtype, gen)
            got = wrapper(*args)
            again = wrapper(*args)  # must give the same bits
            ref = plain(*args)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                                     f"{ref.shape}/{ref.dtype}")
            err = (got.float() - ref.float()).abs().max().item()
            scale = max(ref.float().abs().max().item(), 1.0)
            same = torch.equal(got, again)
            exact = torch.equal(got, ref)
            # a max is exact in any type: the max-pool must equal its
            # plain version bit for bit
            ok = same and (exact if name == "maxpool_3x3_s2"
                           else err <= TOL[dname] * scale)
            ms = cuda_ms(lambda: wrapper(*args))
            dev_ms = device_ms(lambda: wrapper(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            lib = library_call(case, args)
            lib_ms = cuda_ms(lib) if lib is not None else None
            chain = cudnn_chain(case, args)
            chain_ms = cuda_ms(chain) if chain is not None else None
            byts, ops = work(case, args[0].element_size())
            b_ms = byts / PEAK_BYTES * 1e3
            o_ms = ops / PEAK_OPS[dname] * 1e3
            bound_by = "bytes" if b_ms >= o_ms else "operations"
            emit(dict(phase="kernel", name=name, dtype=dname,
                      config=config, shape=list(a["x"]), per_frame=count,
                      max_abs_err=err, tol=TOL[dname] * scale, ok=ok,
                      exact=exact, deterministic=same,
                      ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                      library_ms=lib_ms,
                      cudnn_chain_ms=chain_ms,
                      bound_ms=max(b_ms, o_ms), bound_by=bound_by))
            if not ok:
                raise AssertionError(f"{name} {dname} {a['x']}: max abs err "
                                     f"{err} (tol {TOL[dname] * scale}, "
                                     f"exact {exact}), or a second launch "
                                     "gave other bits")
            s = summ[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            if dtype == torch.bfloat16:  # the main path's type
                s["ms"] += count * ms
                s["device_ms"] += count * dev_ms
                s["plain_ms"] += count * plain_ms
                s["bound"][bound_by] += count * max(b_ms, o_ms)
                s["library_ms"] = (None if lib_ms is None or
                                   s["library_ms"] is None else
                                   s["library_ms"] + count * lib_ms)
                s["cudnn_chain_ms"] = (None if chain_ms is None else
                                       s["cudnn_chain_ms"] + count * chain_ms)
            del args, got, again, ref
    return summary, summary_r101, wrappers


def stream_inputs(torch, cfg, frames, seed=0):
    import numpy as np

    from simpb_tpu_torch.utils.synthetic import synthetic_rig

    w, h = cfg.input_size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    imgs = [torch.randn(1, 6, h, w, 3, generator=gen, device="cuda")
            for _ in range(frames + 1)]
    proj = torch.from_numpy(synthetic_rig(1, (w, h))).cuda()
    t2c = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.02), np.sin(0.02)
    t2c[:2, :2] = [[c, -s], [s, c]]
    t2c[:2, 3] = [0.1, 2.0]  # ~4 m/s forward at 0.5 s a frame
    return imgs, proj, torch.from_numpy(t2c)[None].cuda(), \
        torch.full((1,), 0.5, device="cuda")


def launch_counts():
    from simpb_tpu_torch.ops import conv_fused, sampling
    from simpb_tpu_torch.tools import mosaic_probe
    from simpb_tpu_torch.training import matching

    return {**conv_fused.launch_counts(), **sampling.launch_counts(),
            **mosaic_probe.launch_counts(), **matching.launch_counts()}


def reset_launch_counts():
    from simpb_tpu_torch.ops import conv_fused, sampling
    from simpb_tpu_torch.tools import mosaic_probe
    from simpb_tpu_torch.training import matching

    for mod in (conv_fused, sampling, mosaic_probe, matching):
        mod.reset_launch_counts()


@contextlib.contextmanager
def rebound(*sites):
    """Bind each (module, name) of `sites` (module, name, make) to
    make(the function bound there) for the duration; restore after."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    try:
        for (mod, name, make), (_, _, fn) in zip(sites, saved):
            setattr(mod, name, make(fn))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def recording(calls):
    """Append (name, args, kwargs) of every sampling-wrapper call to
    `calls`, then run the wrapper itself; the hybrid's exact lane, which
    adds into its inputs, is recorded with copies of them taken before."""
    from simpb_tpu_torch.models import dfa, group_attn
    from simpb_tpu_torch.ops import sampling

    def recorder(name, copied=()):
        def make(fn):
            def call(*args, **kwargs):
                kept = tuple(a.clone() if i in copied else a
                             for i, a in enumerate(args))
                calls.append((name, kept, kwargs))
                return fn(*args, **kwargs)
            return call
        return make

    return rebound(
        (dfa, "deformable_aggregation", recorder("deformable_aggregation")),
        (sampling, "_msda_patch_sel", recorder("msda_patch_sel")),
        (group_attn, "msda", recorder("msda")),
        (group_attn, "msda_hybrid", recorder("msda_hybrid")),
        (sampling, "_msda_patch_levels", recorder("msda_patch_levels")),
        (sampling, "msda_hybrid_exact",
         recorder("msda_hybrid_exact", copied=(5, 6))),
        (sampling, "hybrid_selection", recorder("clamp_select")),
        (group_attn, "msda_clamp_demand", recorder("clamp_demand")))


def run_stream(torch, model, cfg, frames, calls=None):
    """Cold frame + `frames` stream frames; returns (decoded list,
    per-frame ms, per-frame launch counts). With `calls`, the sampling
    calls of the last frame are recorded there."""
    from simpb_tpu_torch.training.evaluate import make_stream_steps

    cold, stream = make_stream_steps(model, cfg)
    imgs, proj, t2c, dt = stream_inputs(torch, cfg, frames)
    decs, times, counts = [], [], []
    state = None
    for f, img in enumerate(imgs):
        rec = (recording(calls) if calls is not None and f == len(imgs) - 1
               else contextlib.nullcontext())
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rec:
            if f == 0:
                dec, state = cold(img, proj)
            else:
                dec, state = stream(img, proj, state, dt, t2c)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        after = launch_counts()
        counts.append({k: after[k] - before[k] for k in after
                       if after[k] - before[k]})
        decs.append(dec)
    return decs, times, counts


def frame_kernels(torch, model, cfg, warm=2):
    """The CUDA kernels one stream frame of `model` launches: a cold frame
    and `warm` stream frames, then one more under torch.profiler, its
    kernel events counted (memory copies and sets apart). Returns the
    count, the copies and sets, and the count by kernel name (names cut
    to 90 characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from simpb_tpu_torch.training.evaluate import make_stream_steps

    cold, stream = make_stream_steps(model, cfg)
    imgs, proj, t2c, dt = stream_inputs(torch, cfg, warm + 1)
    _, state = cold(imgs[0], proj)
    for img in imgs[1:-1]:
        _, state = stream(img, proj, state, dt, t2c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stream(imgs[-1], proj, state, dt, t2c)
        torch.cuda.synchronize()
    names, copies = {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
            continue
        names[e.name[:90]] = names.get(e.name[:90], 0) + 1
    return dict(kernels=sum(names.values()), copies_and_sets=copies,
                by_name=dict(sorted(names.items(), key=lambda kv: -kv[1])))


def check_stream(torch, decs):
    prev_ids = None
    carried = 0
    for f, d in enumerate(decs):
        for k in ("boxes_3d", "scores_3d", "cls_scores"):
            if not torch.isfinite(d[k]).all():
                raise AssertionError(f"frame {f}: non-finite {k}")
        s = d["scores_3d"][0]
        if not (s[:-1] >= s[1:]).all():
            raise AssertionError(f"frame {f}: scores not sorted")
        ids = set(d["instance_ids"][0][d["valid"][0]].tolist()) - {-1}
        if prev_ids is not None:
            carried = len(ids & prev_ids)
        prev_ids = ids
    if carried == 0:
        raise AssertionError("no instance id carried into the last frame")
    return carried


def flagship(head_dtype, compute_dtype="bfloat16"):
    """`simpb_r50_704x256_fast` as bench.py builds it (compute and head
    dtype bf16), with the fused trunk; other dtypes on request."""
    import dataclasses

    from simpb_tpu_torch.configs.base import simpb_r50_704x256_fast

    return dataclasses.replace(simpb_r50_704x256_fast(),
                               backbone_fused_infer=True,
                               compute_dtype=compute_dtype,
                               head_dtype=head_dtype)


def phase_slice(torch, head_dtype, frames, calls=None):
    """Stream the flagship with the head in `head_dtype` (trunk bf16):
    cold frame + `frames` stream frames, the launch counts set to 0
    just before and read just after. With `calls`, the last frame's
    sampling calls are recorded there. Returns the counts."""
    from simpb_tpu_torch.training.evaluate import build_model

    cfg = flagship(head_dtype)
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    decs, times, counts = run_stream(torch, model, cfg, frames, calls)
    launches = launch_counts()
    for f, c in enumerate(counts):
        if c != WANT_LAUNCHES:
            raise AssertionError(f"{head_dtype} head, frame {f}: launches "
                                 f"{c}, want {WANT_LAUNCHES}")
    carried = check_stream(torch, decs)
    peak = torch.cuda.max_memory_allocated()
    # the trunk alone (stem, kernels, FPN; CUDA events): the rest of a
    # stream frame is the head, the decode and the host between them
    w, h = cfg.input_size
    img = torch.randn(1, 6, h, w, 3, device="cuda")
    with torch.inference_mode():
        trunk_ms = cuda_ms(lambda: model.extract_feat(img), iters=5)
    stream_ms = sorted(times[1:])
    d = decs[-1]
    emit(dict(phase="slice", config="simpb_r50_704x256_fast",
              backbone_fused_infer=True, trunk="bfloat16", head=head_dtype,
              frames=len(decs), frame_ms=times,
              stream_ms_median=statistics.median(stream_ms),
              stream_ms_range=[stream_ms[0], stream_ms[-1]],
              trunk_ms=trunk_ms, max_memory_allocated=peak,
              launches=launches, launches_per_frame=counts[-1],
              ids_carried_last_frame=carried,
              valid_last_frame=int(d["valid"].sum().item()),
              top_score_last_frame=float(d["scores_3d"][0, 0].item()),
              sampling_calls_recorded=[c[0] for c in calls or ()]))
    del model
    free_cuda(torch)
    return launches


def plain_route():
    """Route the trunk and the sampling ops through the kernels' plain
    versions (the parity reference); the wrappers themselves never do
    that on the card."""
    from simpb_tpu_torch.models import backbone, dfa
    from simpb_tpu_torch.ops import conv_fused, sampling

    sites = (
        (backbone, "maxpool_3x3_s2_fused", conv_fused.maxpool_3x3_s2_plain),
        (backbone, "bottleneck_down_fused_infer", conv_fused.bottleneck_plain),
        (backbone, "bottleneck_fused_infer", conv_fused.bottleneck_plain),
        (backbone, "conv3x3_bias_fused", conv_fused.conv3x3_bias_plain),
        (dfa, "deformable_aggregation", sampling.deformable_aggregation_plain),
        (sampling, "_msda_patch_sel", sampling._msda_patch_sel_plain),
    )
    return rebound(*((mod, n, lambda _, fn=fn: fn) for mod, n, fn in sites))


def strided_view(label, x):
    """The probe's selection as a strided view of x; `.contiguous()` of it
    is the one PyTorch call computing the probe's function."""
    if label.startswith("P5"):
        return x[:, ::2]
    if label.startswith("P6"):
        return x[:, :, ::2]
    return x[:, ::2, ::2]


def phase_probes(torch):
    """The probe tool's path, then each probe kernel against its plain
    version. Returns {label: summary} for the kernels line."""
    from simpb_tpu_torch.tools import mosaic_probe as mp

    reset_launch_counts()
    results = mp.run("cuda")  # the tool's own path: prints its lines
    counts = mp.launch_counts()
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"probe tool: {name} never launched")
    if sum(r["launches"] for r in results) != sum(counts.values()):
        raise AssertionError(f"probe tool: launches {counts} do not add up")
    summary = {}
    for (label, wrapper, plain, c, tpu), r in zip(mp.PROBES, results):
        x = mp.mk((1, mp.H, mp.W, c), device="cuda")
        got = wrapper(x)
        ref = plain(x)
        torch.cuda.synchronize()
        exact = got.shape == ref.shape and torch.equal(got, ref)
        err = (got.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: wrapper(x))
        plain_ms = cuda_ms(lambda: plain(x))
        lib_ms = cuda_ms(lambda: strided_view(label, x).contiguous())
        bound_ms = (x.numel() + ref.numel()) * 2 / PEAK_BYTES * 1e3
        emit(dict(phase="probe", name=label, shape=list(x.shape),
                  exact=exact, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  library_ms=lib_ms, bound_ms=bound_ms, bound_by="bytes",
                  launches=r["launches"]))
        if not exact:
            raise AssertionError(f"{label}: kernel differs from its plain "
                                 f"version by {err}")
        summary[label] = dict(
            name=label, route="cuda",
            source="simpb_tpu_torch/csrc/mosaic_probe.cu", replaces=tpu,
            launches=r["launches"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
            library_ms=lib_ms)
    return summary


def dfa_work(sampling, args, kwargs):
    """(bytes, operations) a DFA call must move and do at least: the
    distinct feature rows its counted samples read at a corner of nonzero
    weight, the counted slots' points and weights, and the output; about
    11 operations per (counted slot, level, channel)."""
    import torch

    col, ss, pts, wts = args[:4]
    loc, _, valid, _ = sampling.dfa_slots(pts, wts,
                                          kwargs.get("gather_capacity"))
    b, total, c = loc.shape[0], col.shape[2], col.shape[3]
    item = col.element_size()
    base = torch.arange(b, device=loc.device)[:, None] * total
    rows = []
    for lvl, (h, w) in enumerate(ss.shapes):
        wx0, wx1, wy0, wy1, x0, y0, y1 = sampling._corner_weights(
            loc, h, w, col.dtype, True)
        start = base + ss.start_indices[lvl]
        for wy, yy in ((wy0, y0), (wy1, y1)):
            for wx, xx in ((wx0, x0), (wx1, x0 + 1)):
                r = start + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
                rows.append(r[valid & (wx != 0) & (wy != 0)])
    n_rows = torch.cat(rows).unique().numel()
    n_slots = int(valid.sum().item())
    levels, groups = wts.shape[-2:]
    out = pts.shape[0] * pts.shape[1] * c * 4
    byts = (n_rows * c + n_slots * (2 + levels * groups)) * item + out
    return byts, 11 * n_slots * levels * c


def msda_work(sampling, args):
    """(bytes, operations) an MSDA-sel call must move and do at least:
    the distinct value rows of its windows, the locations and weights, the
    outputs; 2 operations per (query, level, head, pixel, channel). The
    bf16 route does each product as three exact bf16 products, so its
    operations count three times at the bf16 peak (phase_sampling)."""
    value, ss, loc, attw, heads, ph, pw, k = args
    b, total, c = value.shape
    rows = sampling.msda_sel_windows(total, ss, loc, attw, ph, pw, k)[0]
    q = loc.shape[1]
    byts = (rows.unique().numel() * c * value.element_size()
            + (loc.numel() + attw.numel()) * 4 + b * q * heads * (c + 1) * 4)
    return byts, 2 * b * q * k * heads * ph * pw * c


def synthetic_sampling(torch, dtype, gen, dev="cuda"):
    """Synthetic full-width cases: (label, name, args, kwargs)."""
    from simpb_tpu_torch.ops.format import SpatialShapes

    ss = SpatialShapes(((64, 176), (32, 88), (16, 44), (8, 22)))
    rnd = lambda *s: torch.rand(*s, generator=gen, device=dev)
    col = torch.randn(1, 6, ss.total, 256, generator=gen,
                      device=dev).to(dtype)
    a, p, cams = 900, 13, 6
    wts = rnd(1, a, p, cams, 4, 8)
    wts = (wts / wts.sum((2, 3, 4), keepdim=True)).to(dtype)
    # every slot in range: 11700 per camera, far above the capacity
    dense = (0.02 + 0.96 * rnd(1, a, p, cams, 2)).to(dtype)
    # coordinates at 0, at 1, beyond them and just inside
    edges = torch.tensor([0.0, 1.0, -0.1, 1.1, 2 ** -9, 1 - 2 ** -8, 0.5,
                          0.3], device=dev)
    border = edges[(rnd(1, a, p, cams, 2) * len(edges)).long()].to(dtype)
    # anchors 1-100 with every point out of range: no live entry (anchor
    # 0 stays live, so a fault planted on its entries shows here too)
    dead = border.clone()
    dead[:, 1:101] = -0.5
    cases = [
        ("dfa_capacity_bites", "deformable_aggregation",
         (col, ss, dense, wts), dict(gather_capacity=2048)),
        ("dfa_border", "deformable_aggregation",
         (col, ss, border, wts), dict(gather_capacity=2048)),
        ("dfa_border_no_capacity", "deformable_aggregation",
         (col, ss, border, wts), dict(gather_capacity=None)),
        ("dfa_dead_anchors", "deformable_aggregation",
         (col, ss, dead, wts), dict(gather_capacity=2048)),
        ("dfa_dead_anchors_no_capacity", "deformable_aggregation",
         (col, ss, dead, wts), dict(gather_capacity=None)),
        # every point in range, no capacity: all 6 x 13 x 4 = 312 entries
        # of every anchor live
        ("dfa_all_live", "deformable_aggregation",
         (col, ss, dense, wts), dict(gather_capacity=None)),
    ]
    # MSDA-sel: 6 camera rows x 208 queries, 8 heads x 4 points, 4 levels
    bq, q, heads, pts_ = 6, 208, 8, 4
    n = heads * pts_
    value = col.reshape(bq, ss.total, 256)
    ref = rnd(bq, q, 1, 1, 2)
    loc = ref + 0.1 * torch.randn(bq, q, 4, n, 2, generator=gen, device=dev)
    # queries 40-79: on a 1/16 grid, where window mids fall on rounding
    # ties (loc * size is exact at every level of this pyramid)
    loc[:, 40:80] = torch.floor(rnd(bq, 40, 4, n, 2) * 15 + 1) / 16
    loc[:, 80:100] = -0.5  # every sample dropped
    attw = rnd(bq, q, 4, n)
    attw = attw / attw.sum((2, 3), keepdim=True)
    attw[:, 100:140] = 1.0 / 128  # equal level masses: a tie at every level
    cases.append(("msda_sel_synthetic", "msda_patch_sel",
                  (value, ss, loc.contiguous(), attw.contiguous(), heads, 8,
                   8, 2), {}))
    # windows flush with each level's border: samples spanning pixels
    # [size - 8, size - 1] (queries 0-69: base size - 8, unclamped) or
    # [0, 7] (70-139: base 0), and beyond the right and bottom border
    # (140-207: clamped to size - 8)
    size = torch.tensor([[w, h] for h, w in ss.shapes], device=dev,
                        dtype=torch.float32)[:, None]  # [L, 1, 2]
    span = rnd(bq, q, 4, n, 2) * 7
    span[..., 0, :], span[..., 1, :] = 0.0, 7.0  # the span's two ends
    pix = torch.cat([size - 8 + span[:, :70], span[:, 70:140],
                     size - 1 + 0.999 * rnd(bq, q - 140, 4, n, 2)], 1)
    flush = (pix + 0.5) / size
    cases.append(("msda_sel_flush", "msda_patch_sel",
                  (value, ss, flush.contiguous(), attw.contiguous(), heads,
                   8, 8, 2), {}))
    # 207 queries a row: an odd count of blocks
    cases.append(("msda_sel_ragged", "msda_patch_sel",
                  (value, ss, loc[:, :207].contiguous(),
                   attw[:, :207].contiguous(), heads, 8, 8, 2), {}))
    # the tiny config's head widths (C 64, 4 heads x 4 points) at these
    # levels: the bf16 kernel's one-group-a-warp instance, whose A rows
    # past the heads stay zero and whose warps 4-7 have no channels
    heads_t, q_t = 4, 96
    n_t = heads_t * pts_
    loc_t = rnd(bq, q_t, 1, 1, 2) + 0.1 * torch.randn(
        bq, q_t, 4, n_t, 2, generator=gen, device=dev)
    loc_t[:, 40:60] = -0.5  # every sample dropped
    attw_t = rnd(bq, q_t, 4, n_t)
    attw_t = attw_t / attw_t.sum((2, 3), keepdim=True)
    cases.append(("msda_sel_tiny_widths", "msda_patch_sel",
                  (value[..., :64].contiguous(), ss, loc_t.contiguous(),
                   attw_t.contiguous(), heads_t, 8, 8, 2), {}))
    return cases


def sampling_bound(name, dname, byts, ops):
    """(bound ms, what bounds it) of a sampling call: its bytes over the
    memory rate, or its operations over the peak of the type it computes
    in (DFA and exact MSDA: the CUDA cores, in fp32 for any storage type
    but DFA's bf16 products; the bf16 MSDA-sel route: three bf16 products
    a weight on the tensor cores)."""
    if name == "deformable_aggregation":
        o_ms = ops / PEAK_OPS[dname] * 1e3
    elif (name in ("msda_patch_sel", "msda_patch_levels")
          and dname == "bfloat16"):
        o_ms = 3 * ops / PEAK_OPS["bfloat16"] * 1e3
    else:
        o_ms = ops / PEAK_OPS["float32"] * 1e3
    b_ms = byts / PEAK_BYTES * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def within(got, ref, tol):
    """(ok, max abs errors): each output within `tol` of max(|plain|,
    1); a mask or a count as floats."""
    got, ref = ([t if t.dtype.is_floating_point else t.float() for t in ts]
                for ts in (got, ref))
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    return all(e <= tol * max(r.abs().max().item(), 1.0)
               for e, r in zip(errs, ref)), errs


def hold_case(torch, label, name, wrapper, plain, args, kwargs, tol, work,
              library=None, timed=None):
    """One sampling call through its kernel against its plain version:
    one launch (the count rises by one), a second launch with the same
    bits, every output within `tol` of max(|plain|, 1). Timed through the wrapper
    back to back (`ms`; or through `timed`), on the device alone
    (`device_ms`), the plain version and `library` (a PyTorch call of the
    same function, timed only); `work` is (bytes, operations). Emits the
    case's line and returns it; raises on a failure."""
    from simpb_tpu_torch.ops import sampling

    before = sampling.launch_counts()[name]
    got = wrapper(*args, **kwargs)
    launched = sampling.launch_counts()[name] - before
    ref = plain(*args, **kwargs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    again = wrapper(*args, **kwargs)  # must give the same bits
    again = again if isinstance(again, tuple) else (again,)
    same = all(torch.equal(g_, a_) for g_, a_ in zip(got, again))
    for g_, r_ in zip(got, ref):
        if g_.shape != r_.shape or g_.dtype != r_.dtype:
            raise AssertionError(f"{label}: {g_.shape}/{g_.dtype} vs "
                                 f"{r_.shape}/{r_.dtype}")
    dname = str(next(a for a in args if hasattr(a, "dtype")).dtype
                ).split(".")[-1]
    ok, errs = within(got, ref, tol)
    ok = ok and launched == 1 and same
    bound, bound_by = sampling_bound(name, dname, *work)
    timed = timed or (lambda: wrapper(*args, **kwargs))
    line = dict(phase="sampling", case=label, name=name, dtype=dname,
                max_abs_err=errs, tol_share=tol, ok=ok, launches=launched,
                deterministic=same,
                ms=cuda_ms(timed), device_ms=device_ms(timed),
                plain_ms=cuda_ms(lambda: plain(*args, **kwargs)),
                library_ms=cuda_ms(library) if library else None,
                bound_ms=bound, bound_by=bound_by, bytes=work[0],
                operations=work[1])
    emit(line)
    if not ok:
        raise AssertionError(f"{label}: max abs err {errs} above {tol} of "
                             f"max(|plain|, 1), {launched} launches, or a "
                             "second launch gave other bits")
    return line


def add_frame_call(summary, line):
    """Add one frame call's times and bound to its kernel's summary."""
    s = summary[line["name"]]
    for key in ("ms", "device_ms", "plain_ms"):
        s[key] += line[key]
    if line["library_ms"] is not None:
        s["library_ms"] = (s.get("library_ms") or 0.0) + line["library_ms"]
    s["bound"][line["bound_by"]] += line["bound_ms"]


def kernel_row(name, tpu, launches, s):
    """A kernel's entry of the kernels line from its summary."""
    return dict(name=name, route="cuda",
                source="simpb_tpu_torch/csrc/sampling.cu", replaces=tpu,
                launches=launches, max_abs_err=s["max_abs_err"], ms=s["ms"],
                device_ms=s["device_ms"], plain_ms=s["plain_ms"],
                bound_ms=sum(s["bound"].values()),
                bound_by=max(s["bound"], key=s["bound"].get),
                library_ms=s.get("library_ms"))


def new_summary():
    return dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
                bound={"bytes": 0.0, "operations": 0.0})


# the flagship's sampling kernels (the exact MSDA kernel is held by the
# exact phase)
FLAGSHIP_SAMPLING = ("deformable_aggregation", "msda_patch_sel")


def phase_sampling(torch, calls, slice_launches):
    """DFA and MSDA-sel kernels against their plain versions on the
    recorded main-path calls and the synthetic cases; each call launched
    twice must give bit-identical outputs. Returns {name:
    summary} for the kernels line (ms, device_ms, plain and bound summed
    over one frame's recorded calls)."""
    from simpb_tpu_torch.ops import sampling

    kernels = {n: (w, p, tpu) for n, w, p, tpu in sampling.KERNELS
               if n in FLAGSHIP_SAMPLING}
    summary = {n: new_summary() for n in kernels}
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(f"frame_call_{i}", name, args, kwargs)
             for i, (name, args, kwargs) in enumerate(calls)]
    for dtype in (torch.float32, torch.bfloat16):
        cases += synthetic_sampling(torch, dtype, gen)
    for label, name, args, kwargs in cases:
        wrapper, plain, _ = kernels[name]
        dname = str(args[0].dtype).split(".")[-1]
        tol = SAMPLING_TOL[dname if name == "deformable_aggregation"
                           else "float32"]
        work = (dfa_work(sampling, args, kwargs)
                if name == "deformable_aggregation"
                else msda_work(sampling, args))
        line = hold_case(torch, label, name, wrapper, plain, args, kwargs,
                         tol, work)
        s = summary[name]
        s["max_abs_err"] = max([s["max_abs_err"]] + line["max_abs_err"])
        if label.startswith("frame_call"):  # one stream frame's calls
            add_frame_call(summary, line)
    return {name: kernel_row(name, kernels[name][2], slice_launches[name], s)
            for name, s in summary.items()}


@contextlib.contextmanager
def environment(**env):
    """The environment variables `env` set for the duration."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def exact_config(switch, **env):
    """The config `python -m simpb_tpu_torch.bench` serves under the
    environment switch `switch` (and `env`; trunk and head bf16, the fused
    trunk)."""
    from simpb_tpu_torch import bench

    with environment(**{switch: "1"}, **env):
        return bench.config_name(), bench.config()


# the hybrid's launches a frame: H1, H2 and H3's op instance once a 2D
# layer, H3's guards' instance once a layer with the guards on
HYBRID_LAUNCHES = {"msda_patch_levels": 3, "msda_hybrid_exact": 3,
                   "clamp_select": 3, "clamp_demand": 3}


def exact_launches(cfg):
    """Launches a frame of a served config: the trunk's and DFA's as the
    flagship's, then exact MSDA, MSDA-sel or the hybrid's H1-H3 for the 2D
    cross-attention (H3's guards' instance when the guards are on)."""
    want = {k: v for k, v in WANT_LAUNCHES.items() if k != "msda_patch_sel"}
    if cfg.head.msda_hybrid_mode:
        want.update(HYBRID_LAUNCHES)
        if not cfg.head.guard_sampling:
            del want["clamp_demand"]
    else:
        want["msda_patch_sel" if cfg.head.msda_patch_mode else "msda"] = 3
    return want


def phase_exact_frames(torch):
    """The configs of EXACT_SWITCHES as the bench serves them: cold
    frame + FRAMES stream frames each, the launch counts set to 0 just
    before and read just after; the last frame's sampling calls
    recorded. Returns ({config: launches}, {config: calls})."""
    from simpb_tpu_torch.training.evaluate import build_model

    launches, calls = {}, {}
    for switch in EXACT_SWITCHES:
        name, cfg = exact_config(switch)
        model = build_model(cfg, device="cuda", seed=0)
        rec = []
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        decs, times, counts = run_stream(torch, model, cfg, FRAMES, rec)
        launches[name] = {k: n for k, n in launch_counts().items() if n}
        calls[name] = rec
        want = exact_launches(cfg)
        bad = [(f, c) for f, c in enumerate(counts) if c != want]
        carried = check_stream(torch, decs)
        guards = {k: max(float(d[k].max().item()) for d in decs)
                  for k in decs[0] if k.startswith("guard_")}
        stream_ms = sorted(times[1:])
        emit(dict(phase="exact_frames", config=name, switch=switch,
                  msda_patch_mode=cfg.head.msda_patch_mode,
                  msda_hybrid_mode=cfg.head.msda_hybrid_mode,
                  msda_clamp_capacity=cfg.head.msda_clamp_capacity,
                  msda_gather_capacity=cfg.head.msda_gather_capacity,
                  dfa_gather_capacity=cfg.head.dfa_gather_capacity,
                  guard_sampling=cfg.head.guard_sampling, trunk="bfloat16",
                  head="bfloat16", frames=len(decs), frame_ms=times,
                  stream_ms_median=statistics.median(stream_ms),
                  stream_ms_range=[stream_ms[0], stream_ms[-1]],
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  launches=launches[name], launches_per_frame=counts[-1],
                  guard_maxima=guards, ids_carried_last_frame=carried,
                  sampling_calls_recorded=[c[0] for c in rec]))
        if bad:
            raise AssertionError(f"{name}: launches {bad[0][1]} in frame "
                                 f"{bad[0][0]}, want {want}")
        if cfg.head.guard_sampling != bool(guards):
            raise AssertionError(f"{name}: guard maxima {guards}")
        if cfg.head.msda_hybrid_mode:
            count = frame_kernels(torch, model, cfg)
            emit(dict(phase="frame_kernels", config=name, **count))
            if not count["kernels"]:
                raise AssertionError(f"{name}: the profiler saw no kernel")
        del model, decs
        free_cuda(torch)
    return launches, calls


def msda_exact_work(args):
    """(bytes, operations) an exact MSDA call must move and do at least:
    the distinct value rows its samples read at a corner of nonzero
    weight, the locations and weights, the outputs; 10 operations per
    (query, head, sample, channel): four corner products, three sums and
    the attention's multiply-add."""
    import torch

    from simpb_tpu_torch.ops import sampling

    value, ss, loc, attw = args[:4]
    b, total, c = value.shape
    q, heads, _, points = loc.shape[1:5]
    base = torch.arange(b, device=value.device)[:, None] * total
    rows = []
    for lvl, (h, w) in enumerate(ss.shapes):
        l_ = loc[:, :, :, lvl].reshape(b, -1, 2)
        wx0, wx1, wy0, wy1, x0, y0, y1 = sampling._corner_weights(
            l_, h, w, value.dtype, False)
        start = base + ss.start_indices[lvl]
        for wy, yy in ((wy0, y0), (wy1, y1)):
            for wx, xx in ((wx0, x0), (wx1, x0 + 1)):
                r = start + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
                rows.append(r[(wx != 0) & (wy != 0)])
    n_rows = torch.cat(rows).unique().numel()
    byts = (n_rows * c * value.element_size()
            + (loc.numel() + attw.numel()) * 4 + b * q * heads * (c + 1) * 4)
    return byts, 10 * b * q * heads * ss.num_levels * points * c


def grid_sample_chain(value, ss, loc, attw):
    """The yardstick of exact MSDA: mmcv's plain formulation
    (multi_scale_deformable_attn_pytorch), one `F.grid_sample` a level
    (bilinear, zero padding, align_corners False: the op's semantics)
    and the weighted sum, here sampling each head's locations over all C
    channels, the raw-heads function the kernel computes. In fp32: the
    planes are widened once, outside the timed call, since grid_sample
    takes its grid in the input's type and bf16 positions would compute
    another function. Returns a callable giving sampled [B, Q, heads,
    C]."""
    import torch.nn.functional as F

    b, _, c = value.shape
    q, heads, _, points = loc.shape[1:5]
    planes = [v.transpose(1, 2).reshape(b, c, h, w).float()
              for v, (h, w) in zip(
        value.split([h * w for h, w in ss.shapes], 1), ss.shapes)]

    def run():
        grids = 2.0 * loc - 1.0  # [B, Q, heads, L, P, 2]
        acc = 0.0
        for lvl, plane in enumerate(planes):
            smp = F.grid_sample(
                plane, grids[:, :, :, lvl].reshape(
                    b, q * heads, points, 2), mode="bilinear",
                padding_mode="zeros", align_corners=False)
            acc = acc + (smp * attw[:, :, :, lvl].reshape(
                b, 1, q * heads, points)).sum(-1)  # [B, C, Q * heads]
        return acc.reshape(b, c, q, heads).permute(0, 2, 3, 1)

    return run


def exact_cases(torch, dtype, gen, dev="cuda"):
    """Synthetic exact-MSDA cases at full width (6 camera rows, 8 heads x
    4 levels x 4 points, C 256; the tiny widths C 64, 4 heads once):
    (label, args). Query 0 of every case samples the interior, so that a
    fault planted on it shows on each case."""
    from simpb_tpu_torch.ops.format import SpatialShapes

    ss = SpatialShapes(((64, 176), (32, 88), (16, 44), (8, 22)))
    value = torch.randn(6, ss.total, 256, generator=gen,
                        device=dev).to(dtype)

    def inputs(q, heads=8):
        ref = 0.1 + 0.8 * torch.rand(6, q, 1, 1, 1, 2, generator=gen,
                                     device=dev)
        loc = ref + 0.1 * torch.randn(6, q, heads, 4, 4, 2, generator=gen,
                                      device=dev)
        logits = torch.randn(6, q, heads, 16, generator=gen, device=dev)
        return loc, logits.softmax(-1).reshape(6, q, heads, 4, 4)

    cases = []
    for q in (256, 208):  # no slot capacity, and the guarded config's
        loc, attw = inputs(q)
        cases.append((f"msda_exact_q{q}", (value, ss, loc, attw)))
    # coordinates at 0, at 1, beyond them and just inside them, at every
    # level (the 8x22 level's left border among them)
    loc, attw = inputs(256)
    edges = torch.tensor([0.0, 1.0, -0.1, 1.1, 2 ** -9, 1 - 2 ** -8, -2.0,
                          3.0], device=dev)
    pick = (torch.rand(loc[:, 1:].shape, generator=gen, device=dev)
            * len(edges)).long()
    loc[:, 1:] = edges[pick]
    cases.append(("msda_exact_border", (value, ss, loc, attw)))
    # padded slots: every location 0 (pixel (0, 0) at a quarter weight)
    loc, attw = inputs(256)
    loc[:, 1:] = 0.0
    cases.append(("msda_exact_zero_locations", (value, ss, loc, attw)))
    loc, attw = inputs(207)  # an odd query count
    cases.append(("msda_exact_ragged", (value, ss, loc, attw)))
    loc, attw = inputs(96, heads=4)  # the tiny config's widths
    cases.append(("msda_exact_tiny_widths",
                  (value[..., :64].contiguous(), ss, loc, attw)))
    return cases


def msda_probe_ms(torch, args):
    """Device ms of the exact MSDA kernel on one call of bf16 values
    beside its probes (`msda_kernel`'s U and MODE): the kernel, one
    sample's corner rows in flight (`ahead1`), two samples' (`ahead2`),
    its loads without the arithmetic (`loads_only`) and its arithmetic
    without the loads (`math_only`). What the kernel's time tracks tells
    what bounds it."""
    import ctypes

    from simpb_tpu_torch.ops import _kernels, sampling

    value, ss, loc, attw = args[:4]
    if value.dtype != torch.bfloat16:
        raise AssertionError(f"the probes take bf16 values: {value.dtype}")
    b, _, c = value.shape
    q, heads, _, points = loc.shape[1:5]
    plan = sampling.plan_msda(b, q, heads, points, c, ss.shapes)
    sampled = torch.empty((b, q, heads, c), device=value.device)
    wsum = torch.empty((b, q, heads), device=value.device)
    fn = _kernels.load("sampling").simpb_msda_probe

    def run(ahead, mode):
        _kernels.check(fn(*map(_kernels.ptr, (value, loc, attw, sampled,
                                              wsum)), plan.dims, ahead, mode,
                          ctypes.c_void_p(_kernels.stream_ptr(value))),
                       "msda_probe")

    return {name: device_ms(lambda: run(*am)) for name, am in (
        ("ahead1", (1, 0)), ("ahead2", (2, 0)), ("loads_only", (1, 1)),
        ("math_only", (1, 2)))}


def phase_exact_kernels(torch, calls, launches):
    """Exact MSDA against `msda_plain`, and DFA at the exact configs'
    capacities (4096, 2304) against its plain version: on each config's
    recorded last-frame calls and on synthetic cases in fp32 and bf16,
    each launched twice (the repeats bit-identical), exact MSDA beside
    the grid_sample chain. Returns the exact MSDA kernel's entry of the
    kernels line: launches of the `simpb_r50_704x256` run, ms / device /
    plain / chain / bound summed over one frame's three calls of it."""
    from simpb_tpu_torch.ops import sampling

    kernels = {n: (w, p, tpu) for n, w, p, tpu in sampling.KERNELS}
    main = "simpb_r50_704x256"
    summary = {"msda": new_summary()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for name, rec in calls.items():
        cases += [(f"{name}_call_{i}", n, args, kw)
                  for i, (n, args, kw) in enumerate(rec)
                  if n in ("msda", "deformable_aggregation",
                           "msda_patch_sel")]
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(label, "msda", args, {"raw_heads": True})
                  for label, args in exact_cases(torch, dtype, gen)]
        dfa = {c[0]: c for c in synthetic_sampling(torch, dtype, gen)}
        for cap in (4096, 2304):
            for label in ("dfa_capacity_bites", "dfa_border"):
                _, n, args, _ = dfa[label]
                cases.append((f"{label}_cap{cap}", n, args,
                              {"gather_capacity": cap}))
        del dfa
    for label, name, args, kwargs in cases:
        wrapper, plain, _ = kernels[name]
        dname = str(args[0].dtype).split(".")[-1]
        if name == "msda":
            line = hold_case(torch, label, name, wrapper, plain, args,
                             kwargs, EXACT_TOL[dname], msda_exact_work(args),
                             library=grid_sample_chain(*args[:4]))
            s = summary[name]
            s["max_abs_err"] = max([s["max_abs_err"]] + line["max_abs_err"])
            if label.startswith(main + "_call"):
                add_frame_call(summary, line)
        elif name == "deformable_aggregation":
            hold_case(torch, label, name, wrapper, plain, args, kwargs,
                      SAMPLING_TOL[dname], dfa_work(sampling, args, kwargs))
        else:  # the fast config's MSDA-sel calls
            hold_case(torch, label, name, wrapper, plain, args, kwargs,
                      SAMPLING_TOL["float32"], msda_work(sampling, args))
    # the yardstick computes the same function: fp32, within fp32 sums
    value, ss, loc, attw = exact_cases(torch, torch.float32, gen)[0][1]
    chain = grid_sample_chain(value, ss, loc, attw)()
    ref = sampling.msda_plain(value, ss, loc, attw, raw_heads=True)[0]
    chain_err = (chain - ref).abs().max().item()
    emit(dict(phase="exact_chain", case="msda_exact_q256",
              max_abs_err_vs_plain=chain_err,
              plain_max=ref.abs().max().item()))
    if chain_err > 1e-4 * max(ref.abs().max().item(), 1.0):
        raise AssertionError(f"grid_sample chain differs by {chain_err}")
    i, probe_args = next((i, a) for i, (n, a, _) in enumerate(calls[main])
                         if n == "msda")
    probes = msda_probe_ms(torch, probe_args)
    emit(dict(phase="exact_probes", case=f"{main}_call_{i}",
              dtype=str(probe_args[0].dtype).split(".")[-1],
              device_ms=probes))
    return dict(kernel_row("msda", kernels["msda"][2],
                           launches[main]["msda"], summary["msda"]),
                probes_device_ms=probes)


CLI_GUARDS = ["guard_dfa_overflow", "guard_msda_overflow"]
HYBRID_GUARDS = sorted(CLI_GUARDS + [
    "guard_msda_clamp_overflow", "guard_msda_clamp_demand",
    "guard_msda_percam_clamp_demand"])


def phase_exact_cli(torch, config="r50-guarded", switch="SIMPB_GUARDED",
                    guards_want=CLI_GUARDS):
    """`python -m simpb_tpu_torch.tools.test --config <config>` through
    its `main` over a synthetic 1600x900 infos pkl of EXACT_CLI_FRAMES
    frames (decoded frames served from memory by a dataset subclass: no
    Pillow on the card's machine), the launch counts set to 0 just before
    and read just after (a frame's: those of the bench's config under
    `switch`). The CLI prints the metrics with the guard maxima; it must
    exit 3 exactly when one (not a `*_demand`) is nonzero, and under the
    hybrid only when `guard_msda_clamp_overflow` is."""
    import io
    import tempfile

    import numpy as np

    from simpb_tpu_torch.data import dataset as dataset_mod
    from simpb_tpu_torch.tools import test as test_cli
    from simpb_tpu_torch.utils.guards import check_guard_violations
    from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

    src_h, src_w = 900, 1600
    rng = np.random.default_rng(1)
    images = {}

    class MemoryImages(dataset_mod.NuScenesDataset):
        def load_images(self, paths, dtype=np.float32, scale_hint=None):
            for p in paths:
                if p not in images:
                    images[p] = rng.integers(0, 256, (src_h, src_w, 3),
                                             dtype=np.uint8)
            return [images[p].astype(dtype, copy=False) for p in paths]

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        pkl = write_synthetic_infos(tmp, n_frames=EXACT_CLI_FRAMES,
                                    gap_at=(EXACT_CLI_FRAMES // 2,),
                                    src_hw=(src_h, src_w))
        reset_launch_counts()
        t0 = time.perf_counter()
        with rebound((dataset_mod, "NuScenesDataset",
                      lambda _: MemoryImages)), \
                contextlib.redirect_stdout(out):
            try:
                test_cli.main(["--ann-file", pkl, "--config", config,
                               "--tracking"])
                code = 0
            except SystemExit as e:
                code = e.code
        seconds = time.perf_counter() - t0
    launches = {k: n for k, n in launch_counts().items() if n}
    text = out.getvalue()
    metrics = json.loads(text[text.index("{"):text.rindex("}") + 1])
    guards = {k: v for k, v in metrics.items() if k.startswith("guard_")}
    violated = check_guard_violations(metrics)
    want = {k: EXACT_CLI_FRAMES * n for k, n in exact_launches(
        exact_config(switch)[1]).items()}
    emit(dict(phase="exact_cli", argv=f"--config {config} --tracking",
              frames=EXACT_CLI_FRAMES, source_hw=[src_h, src_w],
              seconds=seconds, exit_code=code, guard_maxima=guards,
              violated=violated, launches=launches,
              metrics={k: metrics[k] for k in ("mAP", "NDS", "AMOTA")}))
    if sorted(guards) != guards_want:
        raise AssertionError(f"exact_cli: guard maxima {guards}")
    if code != (3 if violated else 0):
        raise AssertionError(f"exact_cli: exit {code}, violations "
                             f"{violated}")
    # the hybrid exits 3 only for an overflowing correction lane
    if code == 3 and not guards.get("guard_msda_clamp_overflow", 1) > 0:
        raise AssertionError(f"exact_cli: exit 3 under {config} with "
                             f"guard_msda_clamp_overflow 0: {guards}")
    if launches != want:
        raise AssertionError(f"exact_cli: launches {launches}, want {want}")
    free_cuda(torch)


# the hybrid's kernels against their plain versions, relative to
# max(|plain|, 1): H1 is MSDA-sel over every level (SAMPLING_TOL's fp32
# share: the fp32 sums of up to 4 x 64 weighted pixels a head in another
# order), H2 exact MSDA's lane (EXACT_TOL), H3's two instances bit for bit
# (the op's mask and zeroed weights, the guards' counts: a fixed-order
# sum, and one ulp at the capacity's boundary would swap a corrected
# entry)
HYBRID_TOL = {"msda_patch_levels": SAMPLING_TOL["float32"],
              "msda_hybrid_exact": EXACT_TOL["float32"], "clamp_select": 0.0,
              "clamp_demand": 0.0}
HYBRID_KERNELS = tuple(HYBRID_TOL)
# the hybrid at a capacity covering every entry against the exact MSDA
# kernel, relative to max(|exact|, 1): fp32 values within the windowed
# lane's taper clamp (a sample within 1e-4 px of its window's edge moves
# by up to 1e-4 px, JAX's ~1e-4) and fp32 sums; bf16 values as served,
# where exact MSDA rounds its corner weights and pairs to bf16 and the
# windowed lane weighs in fp32 (a bf16 ulp, 2^-8, a sample)
HYBRID_EXACT_TOL = {"float32": 2e-4, "bfloat16": 1.5e-2}
# the bench's hybrid lines: the config's capacity, and SIMPB_CLAMP_CAP's
HYBRID_CAPS = (256, 832)


def hybrid_wrappers():
    """{name: (wrapper, plain version)} of H1, H2 and H3's two instances
    with the arguments chip_smoke records and makes; the exact lane's
    wrapper adds into copies of its inputs, so that a case can be
    launched twice."""
    from simpb_tpu_torch.ops import sampling

    def h2(value, ss, loc, attw, sel, sampled, wsum):
        return sampling.msda_hybrid_exact(value, ss, loc, attw, sel,
                                          sampled.clone(), wsum.clone())

    kernels = {n: (w, p) for n, w, p, _ in sampling.KERNELS}
    return {"msda_patch_levels": kernels["msda_patch_levels"],
            "msda_hybrid_exact": (h2, sampling.msda_hybrid_exact_plain),
            "clamp_select": kernels["clamp_select"],
            "clamp_demand": kernels["clamp_demand"]}


def hybrid_inputs(torch, gen, q, spread, dev="cuda", heads=8):
    """Full-width hybrid inputs over the r50 levels: 6 camera rows x q
    queries, heads x 4 levels x 4 points, locations at a query's point plus
    `spread` x a normal (so that wider spreads clamp more entries),
    softmax weights. Query 0 samples the interior, its level-0 samples 20
    pixels apart (every case clamps entry 0), query 1 a copy of query 0
    (its entries tie with query 0's)."""
    ref = 0.15 + 0.7 * torch.rand(6, q, 1, 1, 1, 2, generator=gen,
                                  device=dev)
    loc = ref + spread * torch.randn(6, q, heads, 4, 4, 2, generator=gen,
                                     device=dev)
    loc[:, 0] = 0.5 + 0.02 * torch.randn(heads, 4, 4, 2, generator=gen,
                                         device=dev)
    loc[:, 0, :, 0, :, 0] = 0.45 + 0.1 * torch.rand(
        heads, 4, generator=gen, device=dev)
    logits = torch.randn(6, q, heads, 16, generator=gen, device=dev)
    attw = logits.softmax(-1).reshape(6, q, heads, 4, 4)
    loc[:, 1], attw[:, 1] = loc[:, 0], attw[:, 0]
    return loc.contiguous(), attw.contiguous()


def tie_capacity(torch, prio):
    """The capacity at which row 0's top-k splits the tie of queries 0
    and 1 at level 0 (entries 0 and 4): query 0's entry taken, query 1's
    not."""
    order = torch.sort(prio[0], descending=True, stable=True)[1]
    return int((order == 4 * 1 + 0).nonzero()[0, 0].item())


def hybrid_cases(torch, dtype, gen, dev="cuda"):
    """Synthetic full-width cases of H1-H3 in the value type `dtype`:
    (label, name, args). Demand under, at and over the capacity, at a tie
    on the capacity's boundary (the corrected entries as the op selects
    them, by the plain selection), samples past the windows and at and
    beyond the borders, padded slots (location 0) among the corrected
    entries; H1 in the hybrid's layout and, once, in msda_patch's; H3's
    guards' instance on the 256 uncompacted slots with padded and invalid
    slots, and on every op case; H2 with about 5 % of the entries
    corrected; a ragged 207 queries. Query 0 of every
    case has a clamped level 0, a corrected entry and weight on its last
    level, so that a fault planted on it shows on each case."""
    from simpb_tpu_torch.ops import sampling
    from simpb_tpu_torch.ops.format import SpatialShapes

    ss = SpatialShapes(((64, 176), (32, 88), (16, 44), (8, 22)))
    value = torch.randn(6, ss.total, 256, generator=gen,
                        device=dev).to(dtype)
    edges = torch.tensor([0.0, 1.0, -0.1, 1.1, 2 ** -9, 1 - 2 ** -8, 0.5],
                         device=dev)
    cases = []
    for label, q, spread, cap in (("under", 208, 0.004, 832),
                                  ("over", 208, 0.02, 256),
                                  ("at", 208, 0.01, None),
                                  ("tie", 208, 0.02, "tie"),
                                  ("border", 208, 0.01, 256)):
        loc, attw = hybrid_inputs(torch, gen, q, spread, dev)
        if label == "border":  # borders, and padded slots (location 0)
            pick = (torch.rand(loc[:, 2:100].shape, generator=gen,
                               device=dev) * len(edges)).long()
            loc[:, 2:100] = edges[pick]
            loc[:, 100:140] = 0.0
        prio = sampling.clamp_priority_plain(ss, loc, attw, 8, 8)
        demand = int((prio > 0).sum(-1).max().item())
        cap = (demand if cap is None  # "at": the capacity is it
               else tie_capacity(torch, prio) if cap == "tie" else cap)
        k_cap = min(cap, q * 4)
        cases.append((f"clamp_select_{label}", "clamp_select",
                      (ss, loc, attw, 8, 8, k_cap)))
        cases.append((f"clamp_demand_{label}", "clamp_demand",
                      (ss, loc, 8, 8, None)))
        sel = sampling.hybrid_selection_plain(ss, loc, attw, 8, 8,
                                              k_cap)[0]
        if label == "border":
            sel[:, 100:140] = True  # padded slots corrected too
        sel[0, 0, 0] = True
        attw_win = attw * (~sel)[:, :, None, :, None].float()
        cases.append((f"levels_{label}", "msda_patch_levels", (
            value, ss, loc, attw_win, 8, 8, 8)))
        if label == "over":  # msda_patch's layout
            n = 32
            cases.append((f"levels_{label}_patch_layout",
                          "msda_patch_levels", (
                              value, ss, loc.permute(0, 1, 3, 2, 4, 5)
                              .reshape(6, q, 4, n, 2).contiguous(),
                              attw_win.permute(0, 1, 3, 2, 4)
                              .reshape(6, q, 4, n).contiguous(), 8, 8, 8)))
        sampled = torch.randn(6, q, 8, 256, generator=gen, device=dev)
        wsum = torch.rand(6, q, 8, generator=gen, device=dev)
        cases.append((f"exact_lane_{label}", "msda_hybrid_exact",
                      (value, ss, loc, attw, sel.contiguous(), sampled,
                       wsum)))
    # H2 in the trained-checkpoint regime: about 5 % of a row's 832
    # entries corrected (its top 42), query 0's level 0 among them
    loc, attw = hybrid_inputs(torch, gen, 208, 0.01, dev)
    sel = sampling.hybrid_selection_plain(ss, loc, attw, 8, 8, 42)[0]
    sel[:, 0, 0] = True
    cases.append(("exact_lane_sparse", "msda_hybrid_exact", (
        value, ss, loc, attw, sel.contiguous(),
        torch.randn(6, 208, 8, 256, generator=gen, device=dev),
        torch.rand(6, 208, 8, generator=gen, device=dev))))
    # the guards' call: 256 uncompacted slots, padded and invalid ones
    loc, attw = hybrid_inputs(torch, gen, 256, 0.01, dev)
    loc[:, 200:] = 0.0  # padded slots
    valid = torch.rand(6, 256, generator=gen, device=dev) < 0.8
    valid[:, 0] = True
    valid[:, 200:] = False
    cases.append(("clamp_demand_guard_slots", "clamp_demand",
                  (ss, loc, 8, 8, valid.contiguous())))
    # 207 queries: a ragged warp walk
    loc, attw = hybrid_inputs(torch, gen, 207, 0.01, dev)
    cases.append(("clamp_select_ragged", "clamp_select",
                  (ss, loc, attw, 8, 8, 256)))
    cases.append(("clamp_demand_ragged", "clamp_demand",
                  (ss, loc, 8, 8, None)))
    return cases


def levels_work(sampling, args):
    """(bytes, operations) an H1 call must move and do at least: the
    distinct value rows of the windows of its (query, level) items that
    carry weight (a kept sample of nonzero weight; the others add nothing,
    and the kernel neither copies nor multiplies them), the locations and
    weights, the outputs; 2 operations per (item carrying weight, head,
    pixel, channel)."""
    value, ss, loc, attw, heads, ph, pw = args[:7]
    loc, attw = sampling._levels_layout(loc, attw)
    b, total, c = value.shape
    q, levels = loc.shape[1:3]
    rows, _, _, keep, a_s, _, _ = sampling.msda_sel_windows(
        total, ss, loc, attw, ph, pw, levels)
    live = ((a_s * keep) != 0).any(-1)  # [B, Q, L]
    byts = (rows[live].unique().numel() * c * value.element_size()
            + (loc.numel() + attw.numel()) * 4 + b * q * heads * (c + 1) * 4)
    return byts, 2 * int(live.sum().item()) * heads * ph * pw * c


def hybrid_work(name, args):
    """(bytes, operations) an H1-H3 call must move and do at least. H1:
    `levels_work`. H2: the distinct value rows its corrected entries'
    samples read at a corner of nonzero weight, their locations and
    weights, the mask, and the corrected queries' sampled and wsum read
    and written; 10 operations per (corrected entry, head, point,
    channel). H3: the locations (and the op's weights, or the guards'
    valid flags) read once, the op's mask and weights or the guards'
    counts written once; 40 operations a sample."""
    import torch

    from simpb_tpu_torch.ops import sampling

    if name == "msda_patch_levels":
        return levels_work(sampling, args)
    if name == "clamp_select":
        loc, attw = args[1:3]
        return ((loc.numel() + 2 * attw.numel()) * 4 + attw.numel() // 32,
                40 * loc.numel() // 2)
    if name == "clamp_demand":
        loc, valid = args[1], args[4]
        return (loc.numel() * 4 + (valid.numel() if valid is not None else 0)
                + loc.shape[0] * 4, 40 * loc.numel() // 2)
    value, ss, loc, attw, sel = args[:5]
    b, total, c = value.shape
    q, heads, levels, points = loc.shape[1:5]
    base = torch.arange(b, device=value.device)[:, None, None] * total
    rows = []
    for lvl, (h, w) in enumerate(ss.shapes):
        l_ = loc[:, :, :, lvl].reshape(b, q, -1, 2)
        wx0, wx1, wy0, wy1, x0, y0, y1 = sampling._corner_weights(
            l_, h, w, value.dtype, False)
        start = base + ss.start_indices[lvl]
        marked = sel[:, :, lvl][:, :, None]
        for wy, yy in ((wy0, y0), (wy1, y1)):
            for wx, xx in ((wx0, x0), (wx1, x0 + 1)):
                r = start + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
                rows.append(r[marked & (wx != 0) & (wy != 0)])
    n_rows = torch.cat(rows).unique().numel()
    entries = int(sel.sum().item())
    queries = int(sel.any(-1).sum().item())
    byts = (n_rows * c * value.element_size()
            + entries * heads * points * 3 * 4 + sel.numel()
            + 2 * queries * heads * (c + 1) * 4)
    return byts, 10 * entries * heads * points * c


def hybrid_library(name, args):
    """H2's yardstick: the grid_sample chain over every entry with the
    uncorrected ones' weights zeroed (one call of PyTorch's that computes
    the exact lane's sums); none for H1 and H3."""
    if name != "msda_hybrid_exact":
        return None
    value, ss, loc, attw, sel = args[:5]
    return grid_sample_chain(value, ss, loc,
                             attw * sel[:, :, None, :, None].float())


def launch_floor_ms(torch):
    """Device ms of one launch that does nothing (`torch.cuda._sleep(0)`):
    the floor a latency-bound launch cannot go below."""
    return device_ms(lambda: torch.cuda._sleep(0), iters=50)


def hold_hybrid(torch, cases, summary, frame_label):
    """H1, H2 and H3's instances on `cases` ((label, name, args)) through
    `hold_case` at HYBRID_TOL (H2 timed in place on scratch copies, its
    corrected entries and marked queries beside its time in an
    `exact_lane` line, kept in summary["msda_hybrid_exact"]["lanes"]);
    each kernel's largest error into `summary`, and the times and bounds
    of the cases whose label starts with `frame_label` (one frame's
    calls)."""
    from simpb_tpu_torch.ops import sampling

    wrappers = hybrid_wrappers()
    for label, name, args in cases:
        wrapper, plain = wrappers[name]
        timed = None
        if name == "msda_hybrid_exact":  # in place, on scratch copies
            scratch = (args[5].clone(), args[6].clone())
            timed = lambda: sampling.msda_hybrid_exact(*args[:5], *scratch)
        line = hold_case(torch, label, name, wrapper, plain, args, {},
                         HYBRID_TOL[name], hybrid_work(name, args),
                         library=hybrid_library(name, args), timed=timed)
        s = summary[name]
        s["max_abs_err"] = max([s["max_abs_err"]] + line["max_abs_err"])
        if name == "msda_hybrid_exact":
            sel = args[4]
            lane = dict(phase="exact_lane", case=label,
                        dtype=line["dtype"],
                        corrected_entries=int(sel.sum().item()),
                        entries=sel.numel(),
                        marked_queries=int(sel.any(-1).sum().item()),
                        queries=sel.shape[0] * sel.shape[1],
                        device_ms=line["device_ms"],
                        bound_ms=line["bound_ms"])
            emit(lane)
            s.setdefault("lanes", {})[f"{label}_{line['dtype']}"] = lane
        if label.startswith(frame_label):
            add_frame_call(summary, line)


def exact_lane_probes(torch, args):
    """H2's device ms on one call's shapes: with its own inputs; with no
    entry marked (the launch and the items returning at once); with every
    entry marked (every item walks every level); every entry marked with
    every sample at the image's centre (the corner rows stay in L1: the
    loads' floor) and with the samples spread uniformly over each level
    (no reuse: every corner row from L2 or HBM): what sets H2's time
    (PERF.md §6)."""
    from simpb_tpu_torch.ops import sampling

    value, ss, loc, attw, sel, sampled, wsum = args
    gen = torch.Generator(device=loc.device).manual_seed(7)
    every = torch.ones_like(sel)
    centre = (0.5 + 1e-3 * torch.rand(loc.shape, generator=gen,
                                      device=loc.device)).contiguous()
    spread = torch.rand(loc.shape, generator=gen,
                        device=loc.device).contiguous()
    out = {}
    for key, l_, mask in (("call", loc, sel),
                          ("none_marked", loc, torch.zeros_like(sel)),
                          ("all_marked", loc, every),
                          ("all_marked_rows_in_l1", centre, every),
                          ("all_marked_rows_spread", spread, every)):
        s_, w_ = sampled.clone(), wsum.clone()
        out[key] = device_ms(lambda: sampling.msda_hybrid_exact(
            value, ss, l_, attw, mask, s_, w_))
    return out


def positional(fn, args, kwargs):
    """A recorded call's arguments as positional ones of `fn` (a plain
    version), its defaults filled."""
    import inspect

    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    return tuple(bound.args)


def recorded_hybrid(calls, label):
    """The H1-H3 calls of `calls` as hold_hybrid's cases."""
    wrappers = hybrid_wrappers()
    return [(f"{label}_call_{i}", n, positional(wrappers[n][1], args, kw))
            for i, (n, args, kw) in enumerate(calls) if n in HYBRID_KERNELS]


def phase_hybrid_kernels(torch, calls, launches):
    """H1, H2 and H3's instances against their plain versions on the
    hybrid config's recorded last-frame calls and on `hybrid_cases` in
    fp32 and bf16, each launched twice (the repeats bit-identical), timed
    as in phase 6 (H2 in place on scratch copies; its probes on the
    first frame call, `exact_lane_probes`); then `msda_hybrid` on the
    card against `msda_hybrid_plain` at demand under, at and over the
    capacity and at a tie on its boundary (the corrected entries equal),
    and on the recorded calls at a capacity covering every entry against
    the exact MSDA kernel (the largest error printed, held at
    HYBRID_EXACT_TOL). Returns the kernels' entries of the kernels line:
    launches of the hybrid's frames, ms / device / plain / bound summed
    over one frame's calls; H2's with its probes and its sparse case
    beside the empty-launch floor."""
    from simpb_tpu_torch.ops import sampling

    main = "simpb_r50_704x256_hybrid"
    tpu = {n: t for n, _, _, t in sampling.KERNELS}
    summary = {n: new_summary() for n in HYBRID_KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = recorded_hybrid(calls[main], main)
    for dtype in (torch.float32, torch.bfloat16):
        cases += hybrid_cases(torch, dtype, gen)
    hold_hybrid(torch, cases, summary, main + "_call")
    floor = launch_floor_ms(torch)
    emit(dict(phase="hybrid_floor", launch_floor_device_ms=floor))
    probes = exact_lane_probes(torch, next(
        a for _, n, a in cases if n == "msda_hybrid_exact"))
    emit(dict(phase="exact_lane_probes", case=f"{main}_call",
              device_ms=probes))

    # the op on the card against its plain version, the selection equal
    from simpb_tpu_torch.ops.format import SpatialShapes

    ss = SpatialShapes(((64, 176), (32, 88), (16, 44), (8, 22)))
    value = torch.randn(6, ss.total, 256, generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        v = value.to(dtype)
        for label, spread, cap in (("under", 0.004, 256), ("at", 0.01, None),
                                   ("over", 0.02, 256), ("tie", 0.02, None)):
            loc, attw = hybrid_inputs(torch, gen, 208, spread)
            prio = sampling.clamp_priority_plain(ss, loc, attw, 8, 8)
            demand = int((prio > 0).sum(-1).max().item())
            if label == "at":
                cap = demand
            elif label == "tie":  # the capacity splits queries 0 and 1
                cap = tie_capacity(torch, prio)
            got = sampling.msda_hybrid(v, ss, loc, attw, clamp_capacity=cap,
                                       raw_heads=True)
            ref = sampling.msda_hybrid_plain(v, ss, loc, attw,
                                             clamp_capacity=cap,
                                             raw_heads=True)
            sel = sampling.hybrid_selection(ss, loc, attw, 8, 8,
                                            min(cap, 832))[0]
            sel_ref = sampling.hybrid_selection_plain(ss, loc, attw, 8, 8,
                                                      min(cap, 832))[0]
            ok, errs = within(got, ref, SAMPLING_TOL["float32"])
            same_sel = torch.equal(sel, sel_ref)
            emit(dict(phase="hybrid_op", case=label,
                      dtype=str(dtype).split(".")[-1], capacity=cap,
                      demand=demand, corrected=int(sel.sum().item()),
                      max_abs_err=errs, same_selection=same_sel, ok=ok))
            if not (ok and same_sel):
                raise AssertionError(f"hybrid op {label}: errors {errs}, "
                                     f"selection equal {same_sel}")

    # exactness on the recorded calls: capacity = every entry
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (n, args, kw) in enumerate(calls[main]):
        if n != "msda_hybrid":
            continue
        v, ss_, loc, attw = args
        q = loc.shape[1]
        demand = int(sampling.msda_clamp_demand(ss_, loc, 8, 8).max().item())
        for vt in (v, v.float()):
            dname = str(vt.dtype).split(".")[-1]
            got = sampling.msda_hybrid(vt, ss_, loc, attw, patch_h=8,
                                       patch_w=8, clamp_capacity=q * 4,
                                       raw_heads=True)
            ref = sampling.msda(vt, ss_, loc, attw, raw_heads=True)
            ok, errs = within(got, ref, HYBRID_EXACT_TOL[dname])
            rel = [e / max(r.abs().max().item(), 1.0)
                   for e, r in zip(errs, ref)]
            worst[dname] = max([worst[dname]] + rel)
            emit(dict(phase="hybrid_exactness", case=f"{main}_call_{i}",
                      dtype=dname, demand=demand, capacity=q * 4,
                      max_abs_err=errs, share_of_max=rel,
                      tol_share=HYBRID_EXACT_TOL[dname], ok=ok))
            if not ok:
                raise AssertionError(f"hybrid against exact MSDA: {errs}")
    rows = {}
    for name in HYBRID_KERNELS:
        rows[name] = kernel_row(name, tpu[name], launches[main][name],
                                summary[name])
    for name in ("clamp_select", "clamp_demand"):
        rows[name]["launch_floor_device_ms"] = floor
    h2 = rows["msda_hybrid_exact"]
    h2["hybrid_vs_exact_max_share"] = worst
    h2["probes_device_ms"] = probes
    lanes = summary["msda_hybrid_exact"]["lanes"]
    h2["sparse"] = {d: dict(launch_floor_device_ms=floor, **{
        k: lanes[f"exact_lane_sparse_{d}"][k] for k in (
            "device_ms", "bound_ms", "corrected_entries",
            "marked_queries")}) for d in ("float32", "bfloat16")}
    return rows


def phase_hybrid_bench(torch):
    """The bench's lines under SIMPB_HYBRID (capacity 256) and with
    SIMPB_CLAMP_CAP=832 (every entry of the 208 slots), each through
    `run_benchmark` at BENCH_WINDOW frames with the launch counts set to 0
    just before and read just after."""
    from simpb_tpu_torch import bench
    from simpb_tpu_torch.utils.benchmark import run_benchmark

    for cap in HYBRID_CAPS:
        env = {} if cap == 256 else {"SIMPB_CLAMP_CAP": str(cap)}
        _, cfg = exact_config("SIMPB_HYBRID", **env)
        if cfg.head.msda_clamp_capacity != cap:
            raise AssertionError(f"hybrid bench: capacity "
                                 f"{cfg.head.msda_clamp_capacity}")
        reset_launch_counts()
        fps, stats = run_benchmark(cfg, window=BENCH_WINDOW, batch_size=1,
                                   return_stats=True)
        launches = {k: n for k, n in launch_counts().items() if n}
        free_cuda(torch)
        emit(bench.result(fps, stats))
        want = {k: 2 * BENCH_WINDOW * n
                for k, n in exact_launches(cfg).items()}
        emit(dict(phase="hybrid_bench", config="simpb_r50_704x256_hybrid",
                  env=dict(SIMPB_HYBRID="1", **env), clamp_capacity=cap,
                  window=BENCH_WINDOW, fps=fps,
                  peak_hbm_bytes=stats["peak_hbm_bytes"], launches=launches))
        if not fps > 0 or launches != want:
            raise AssertionError(f"hybrid bench: fps {fps}, launches "
                                 f"{launches}, want {want}")


def phase_exact(torch):
    """The exact-sampling serving path (see the module docstring); returns
    the exact MSDA kernel's entry of the kernels line and the hybrid's
    three."""
    launches, calls = phase_exact_frames(torch)
    row = phase_exact_kernels(torch, calls, launches)
    rows = phase_hybrid_kernels(torch, calls, launches)
    del calls
    free_cuda(torch)
    phase_exact_cli(torch)
    phase_exact_cli(torch, "r50-hybrid", "SIMPB_HYBRID", HYBRID_GUARDS)
    phase_hybrid_bench(torch)
    return [row] + [rows[n] for n in HYBRID_KERNELS]


def phase_parity(torch):
    """The slice through the kernels and through their plain versions
    (trunk and sampling), one cold frame at full width. fp32: the two
    routes' last-layer outputs within SLICE_ATOL / SLICE_RTOL. bf16 head
    and trunk (the main path): both routes against the fp32 plain route,
    each last-layer output's relative L2 error through the kernels at
    most BF16_SLICE_RATIO times the plain bf16 route's plus
    BF16_SLICE_FLOOR."""
    from simpb_tpu_torch.training.evaluate import build_model

    keys = ("prediction", "classification", "quality")

    def run(cfg):
        """(kernels' outputs, plain versions' outputs)."""
        model = build_model(cfg, device="cuda", seed=0)
        imgs, proj, _, _ = stream_inputs(torch, cfg, 0)
        outs = []
        for ctx in (contextlib.nullcontext(), plain_route()):
            with ctx, torch.inference_mode():
                out = model(imgs[0], proj)
            outs.append({k: out[k][-1].float() for k in keys})
        del model
        free_cuda(torch)
        return outs

    k32, p32 = run(flagship("float32", "float32"))
    errs = {}
    for key in keys:
        diff = (k32[key] - p32[key]).abs()
        errs[key] = diff.max().item()
        if not (diff <= SLICE_ATOL + SLICE_RTOL * p32[key].abs()).all():
            raise AssertionError(f"parity {key}: max abs err {errs[key]}")
    emit(dict(phase="parity", config="simpb_r50_704x256_fast", dtype="fp32",
              tf32=False, atol=SLICE_ATOL, rtol=SLICE_RTOL, max_abs_err=errs))

    k16, p16 = run(flagship("bfloat16"))
    rel = lambda a, r: ((a - r).norm() / r.norm()).item()
    out = {}
    for key in keys:
        ek, ep = rel(k16[key], p32[key]), rel(p16[key], p32[key])
        out[key] = dict(kernels=ek, plain_bf16=ep,
                        max_abs_kernels_vs_plain=(k16[key] - p16[key])
                        .abs().max().item(),
                        ok=bool(torch.isfinite(k16[key]).all()) and
                        ek <= BF16_SLICE_RATIO * ep + BF16_SLICE_FLOOR)
    emit(dict(phase="parity", config="simpb_r50_704x256_fast",
              dtype="bf16 trunk and head", reference="fp32 plain route",
              ratio=BF16_SLICE_RATIO, floor=BF16_SLICE_FLOOR,
              rel_l2_vs_fp32_plain=out))
    bad = {k: v for k, v in out.items() if not v["ok"]}
    if bad:
        raise AssertionError(f"bf16 slice parity failed: {bad}")


def r101_config(name):
    """The config `python -m simpb_tpu_torch.tools.test --config <name>
    --head-bf16` serves: trunk and head bf16, `backbone_fused_infer` set
    (the detector takes the module trunk under `stem_s2d`). `day0-r101`:
    the config of `tools/day0.py --config r101`'s demand pass (the hybrid
    at a capacity of every entry, guards on, trunk bf16, head fp32)."""
    from simpb_tpu_torch.tools import day0
    from simpb_tpu_torch.tools import test as test_cli

    if name == "day0-r101":
        return day0.measurement_config("r101")[0]
    return test_cli.build_config(test_cli.parse_args(
        ["--ann-file", "unused", "--config", name, "--head-bf16"]))


def phase_r101(torch):
    """Both ResNet-101 configs at 1408x512 as the eval CLI serves them,
    and day 0's demand pass at r101 (R101_LAUNCHES), bs 1: a cold frame
    and FRAMES stream frames each, the launch counts set to 0 just before
    and read just after, checked every frame; the stream's checks; frame
    ms, their median and range, the trunk's ms alone and the peak device
    memory. Then H1-H3 against their plain versions on the demand pass's
    last-frame calls (`hold_hybrid`). Returns ({config: launches}, the
    hybrid kernels' r101 entries: launches of its frames, ms / device /
    plain / bound summed over one frame's calls)."""
    from simpb_tpu_torch.models.detector import uses_fused_trunk
    from simpb_tpu_torch.ops import sampling
    from simpb_tpu_torch.training.evaluate import build_model

    out, rec = {}, []
    for name, want in R101_LAUNCHES.items():
        cfg = r101_config(name)
        model = build_model(cfg, device="cuda", seed=0)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        decs, times, counts = run_stream(
            torch, model, cfg, FRAMES,
            rec if cfg.head.msda_hybrid_mode else None)
        out[name] = launch_counts()
        for f, c in enumerate(counts):
            if c != want:
                raise AssertionError(f"{name}, frame {f}: launches {c}, "
                                     f"want {want}")
        carried = check_stream(torch, decs)
        peak = torch.cuda.max_memory_allocated()
        w, h = cfg.input_size
        img = torch.randn(1, 6, h, w, 3, device="cuda")
        with torch.inference_mode():
            trunk_ms = cuda_ms(lambda: model.extract_feat(img), iters=5)
        stream_ms = sorted(times[1:])
        emit(dict(phase="r101", cli_config=name,
                  config=("simpb_r101_1408x512_fast" if cfg.stem_s2d else
                          "simpb_r101_1408x512"),
                  msda_hybrid_mode=cfg.head.msda_hybrid_mode,
                  msda_clamp_capacity=cfg.head.msda_clamp_capacity,
                  trunk_route=("fused" if uses_fused_trunk(cfg) else
                               "module"), stem_s2d=cfg.stem_s2d,
                  input_size=list(cfg.input_size), dtype=cfg.compute_dtype,
                  head=cfg.head_dtype, frames=len(decs), frame_ms=times,
                  stream_ms_median=statistics.median(stream_ms),
                  stream_ms_range=[stream_ms[0], stream_ms[-1]],
                  trunk_ms=trunk_ms, max_memory_allocated=peak,
                  launches=out[name], launches_per_frame=counts[-1],
                  ids_carried_last_frame=carried,
                  valid_last_frame=int(decs[-1]["valid"].sum().item())))
        del model, decs
        free_cuda(torch)
    tpu = {n: t for n, _, _, t in sampling.KERNELS}
    summary = {n: new_summary() for n in HYBRID_KERNELS}
    hold_hybrid(torch, recorded_hybrid(rec, "day0-r101"), summary,
                "day0-r101_call")
    del rec
    free_cuda(torch)
    return out, {n: r101_entry(kernel_row(n, tpu[n], out["day0-r101"][n],
                                          summary[n]))
                 for n in HYBRID_KERNELS}


def r101_entry(row):
    """A kernels-line entry's measurements, for the `r101` dict of the
    kernel's entry."""
    return {k: v for k, v in row.items()
            if k not in ("name", "route", "source", "replaces")}


def phase_trunk(torch, name="r50", module=False):
    """ResNet + FPN at the input of `name` (r50: the main path's
    simpb_r50_704x256_fast; r101: simpb_r101_1408x512) in bf16 through
    the fused trunk's kernels and through their plain versions, each
    against the fp32 plain fused trunk: per FPN level the kernels'
    relative L2 error may be at most TRUNK_RATIO times the plain route's
    plus TRUNK_FLOOR. The kernel phase's checks use random activations;
    this one the trunk's own. With `module`, on the same weights the
    module trunk with the s2d stem (simpb_r101_1408x512_fast's): through
    K1 equal to its plain route bit for bit (K1 is exact and the rest is
    cuDNN either way); in fp32 within MODULE_TRUNK_FP32_REL and in bf16
    within MODULE_TRUNK_BF16_REL (relative L2 per level) of the fp32
    fused trunk. The stem timed as each trunk runs it and, as a
    yardstick, as the bf16 conv the fused stem replaced."""
    import dataclasses

    from simpb_tpu_torch.configs.base import simpb_r50_704x256_fast
    from simpb_tpu_torch.training.evaluate import build_model

    cfg = (r101_config("r101") if name == "r101" else dataclasses.replace(
        simpb_r50_704x256_fast(), backbone_fused_infer=True))
    model = build_model(cfg, device="cuda", seed=0)
    w, h = cfg.input_size
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(6, h, w, 3, generator=gen, device="cuda")
    net, fpn = model.img_backbone, model.img_neck

    def fused(dtype):
        with torch.inference_mode():
            return [f.float() for f in fpn(net(x, dtype), dtype)]

    def module_trunk(dtype):
        with torch.inference_mode():
            return [f.float() for f in fpn.forward_train(
                net.forward_module(x, dtype), dtype)]

    with plain_route():
        ref = fused(torch.float32)
        plain = fused(torch.bfloat16)
    kern = fused(torch.bfloat16)
    # the stem as the trunk runs it (fp32 sum of the bf16-rounded image
    # and kernel into the BN) and, timed only, the bf16 conv it replaced
    stem_w, stem_f, stem_b, _ = net.folded(x.device, torch.bfloat16)
    w16 = stem_w.bfloat16()
    xc = x.bfloat16().permute(0, 3, 1, 2)

    def bf16_conv_stem():
        y = torch.nn.functional.conv2d(xc, w16, stride=2, padding=3)
        return torch.relu((y.permute(0, 2, 3, 1).float() * stem_f + stem_b)
                          .bfloat16())

    with torch.inference_mode():
        stems = dict(stem_ms=cuda_ms(lambda: net.stem(x, torch.bfloat16)),
                     bf16_conv_stem_ms=cuda_ms(bf16_conv_stem))
    mods = [{}] * len(ref)
    rel = lambda a, r: ((a - r).norm() / r.norm()).item()
    if module:
        net.stem_s2d = True
        mod32 = module_trunk(torch.float32)
        mod16 = module_trunk(torch.bfloat16)
        with plain_route():
            mod16_plain = module_trunk(torch.bfloat16)
        with torch.inference_mode():
            stems["module_s2d_stem_ms"] = cuda_ms(
                lambda: net._stem_module(x, torch.bfloat16))
            net.stem_s2d = False
            stems["module_7x7_stem_ms"] = cuda_ms(
                lambda: net._stem_module(x, torch.bfloat16))
        mods = [dict(module_fp32=rel(m32, r), module_bf16=rel(m16, r),
                     module_k1_equals_plain=torch.equal(m16, m16p),
                     module_finite=bool(torch.isfinite(m16).all()),
                     module_shape=m16.shape == r.shape)
                for m32, m16, m16p, r in zip(mod32, mod16, mod16_plain, ref)]
    levels = []
    for lvl, (k, p, r, m) in enumerate(zip(kern, plain, ref, mods)):
        ek, ep = rel(k, r), rel(p, r)
        ok = bool(torch.isfinite(k).all()) and k.shape == r.shape and \
            ek <= TRUNK_RATIO * ep + TRUNK_FLOOR
        if m:
            ok = (ok and m.pop("module_finite") and m.pop("module_shape")
                  and m["module_k1_equals_plain"]
                  and m["module_fp32"] <= MODULE_TRUNK_FP32_REL
                  and m["module_bf16"] <= MODULE_TRUNK_BF16_REL)
        levels.append(dict(level=lvl, shape=list(k.shape), kernels=ek,
                           plain_bf16=ep, **m, ok=ok))
    emit(dict(phase="trunk" if name == "r50" else f"trunk_{name}",
              config=("simpb_r101_1408x512" if name == "r101" else
                      "simpb_r50_704x256_fast"),
              **(dict(module_config="simpb_r101_1408x512_fast",
                      module_fp32_rel=MODULE_TRUNK_FP32_REL,
                      module_bf16_rel=MODULE_TRUNK_BF16_REL)
                 if module else {}),
              dtype="bfloat16", ratio=TRUNK_RATIO, floor=TRUNK_FLOOR,
              rel_l2_vs_fp32_plain=levels, **stems))
    bad = [lv for lv in levels if not lv["ok"]]
    if bad:
        raise AssertionError(f"{name} bf16 trunk check failed: {bad}")
    del model, net, fpn
    free_cuda(torch)


def eval_metric_keys():
    """The keys of `streaming_eval(tracking=True)`'s metrics, in the JAX
    package's order: (detection keys, tracking keys always present, the
    per-class tracking keys that may follow)."""
    from simpb_tpu_torch.configs.base import CLASS_NAMES
    from simpb_tpu_torch.data.tracking_eval import TRACKING_CLASSES

    det = (["mAP", "mATE", "mASE", "mAOE", "mAVE", "mAAE", "NDS"]
           + [f"AP_{c}" for c in CLASS_NAMES])
    trk = ["AMOTA", "AMOTP", "MOTA", "MOTP", "RECALL", "IDS", "FRAG", "FP",
           "FN", "TP", "MT", "ML"]
    per_class = [f"{m}_{c}" for c in TRACKING_CLASSES
                 for m in ("AMOTA", "AMOTP")]
    return det, trk, per_class


def phase_eval(torch, device="cuda"):
    """`streaming_eval` over a synthetic val set at the release source
    size, the flagship as bench.py serves it; see the module docstring."""
    import math
    import tempfile

    import numpy as np

    from simpb_tpu_torch.data import native_preprocess
    from simpb_tpu_torch.data.dataset import NuScenesDataset
    from simpb_tpu_torch.data.postprocess import format_nuscenes_submission
    from simpb_tpu_torch.tools.test import eval_aug_conf
    from simpb_tpu_torch.training import evaluate
    from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

    src_h, src_w = 900, 1600
    cfg = flagship("bfloat16")
    model = evaluate.build_model(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    host_ms, frames, native = [], [], []
    seen = {}

    class MemoryImages(NuScenesDataset):
        """Serves decoded frames from memory; times `get_sample`."""

        def load_images(self, paths, dtype=np.float32, scale_hint=None):
            return [images[p].astype(dtype, copy=False) for p in paths]

        def get_sample(self, idx):
            t0 = time.perf_counter()
            sample = super().get_sample(idx)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            return sample

    def timed_steps(make):
        def steps(model, cfg):
            def timed(fn):
                def step(*args):
                    frames.append(dict(t0=time.perf_counter(),
                                       before=launch_counts()))
                    return fn(*args)
                return step
            return tuple(timed(fn) for fn in make(model, cfg))
        return steps

    def on_host(fn):
        def to_host(dec):
            out = fn(dec)
            frames[-1].update(ms=(time.perf_counter() - frames[-1]["t0"])
                              * 1e3, after=launch_counts(), dec=out)
            return out
        return to_host

    def counted(fn):
        def pre(*args, **kwargs):
            native.append(1)
            return fn(*args, **kwargs)
        return pre

    def scoring(fn):
        def score(preds, gts, scene_ids, tracking):
            seen["scene_ids"] = list(scene_ids)
            return fn(preds, gts, scene_ids, tracking)
        return score

    with tempfile.TemporaryDirectory() as tmp:
        pkl = write_synthetic_infos(tmp, n_frames=EVAL_FRAMES,
                                    gap_at=(EVAL_FRAMES // 2,),
                                    src_hw=(src_h, src_w))
        dataset = MemoryImages(
            pkl, test_mode=True, sequences_split_num=1,
            data_aug_conf=eval_aug_conf(cfg, src_h, src_w))
    images = {c["data_path"]: rng.integers(0, 256, (src_h, src_w, 3),
                                           dtype=np.uint8)
              for info in dataset.data_infos for c in info["cams"].values()}
    reset_launch_counts()
    with rebound((evaluate, "make_stream_steps", timed_steps),
                 (evaluate, "_decode_to_host", on_host),
                 (evaluate, "_score", scoring),
                 (native_preprocess, "preprocess_image", counted)):
        metrics, preds, tokens = evaluate.streaming_eval(
            model, cfg, dataset, tracking=True)
    launches = launch_counts()
    eval_host_ms = host_ms[:]

    # the same samples through make_stream_steps again: every frame's
    # decode must come back bit for bit
    cold, stream = evaluate.make_stream_steps(model, cfg)
    state = prev = None
    identical = []
    for idx, frame in enumerate(frames):
        s = dataset.get_sample(idx)
        img = torch.from_numpy(s["img"][None]).to(device)
        proj = torch.from_numpy(s["projection_mat"][None]).to(device)
        if state is None:
            dec, state = cold(img, proj)
        else:
            dt = torch.tensor([s["timestamp"] - prev["timestamp"]],
                              dtype=torch.float32, device=device)
            t2c = torch.from_numpy((np.linalg.inv(s["lidar2global"])
                                    @ prev["lidar2global"])[None]
                                   .astype(np.float32)).to(device)
            dec, state = stream(img, proj, state, dt, t2c)
        prev = s
        again = evaluate._decode_to_host(dec)
        identical.append(sorted(again) == sorted(frame["dec"]) and all(
            again[k].dtype == frame["dec"][k].dtype
            and again[k].tobytes() == frame["dec"][k].tobytes()
            for k in again))

    per_frame = [{k: f["after"][k] - f["before"][k] for k in f["after"]
                  if f["after"][k] - f["before"][k]} for f in frames]
    det, trk, per_class = eval_metric_keys()
    keys = list(metrics)
    keys_ok = (keys[:len(det) + len(trk)] == det + trk
               and set(keys[len(det) + len(trk):]) <= set(per_class))
    want_scenes = [0] * (EVAL_FRAMES // 2) + [1] * (EVAL_FRAMES // 2)
    sub = format_nuscenes_submission(
        [{"boxes_3d": p["boxes"], "scores_3d": p["scores"],
          "labels_3d": p["labels"], "instance_ids": p["track_ids"]}
         for p in preds], tokens, tracking=True)
    finite = all(np.isfinite(p["boxes"]).all() and np.isfinite(
        p["scores"]).all() for p in preds)
    frame_ms = [f["ms"] for f in frames]
    emit(dict(phase="eval", config="simpb_r50_704x256_fast",
              trunk="bfloat16", head="bfloat16", frames=len(frames),
              source_hw=[src_h, src_w], cameras=6,
              native_preprocess=native_preprocess.available(),
              native_calls=len(native),
              get_sample_host_ms_median=statistics.median(eval_host_ms),
              get_sample_host_ms_range=[min(eval_host_ms),
                                        max(eval_host_ms)],
              frame_ms_median=statistics.median(frame_ms),
              frame_ms_range=[min(frame_ms), max(frame_ms)],
              frame_ms=frame_ms, scene_ids=seen.get("scene_ids"),
              launches=launches, launches_per_frame=per_frame[-1],
              decode_bit_identical_rerun=identical,
              predictions=sum(len(p["labels"]) for p in preds),
              submission_boxes=sum(map(len, sub["results"].values())),
              metrics={k: None if math.isnan(v) else v
                       for k, v in metrics.items()}))
    json.dumps(sub)
    problems = []
    if not native_preprocess.available() or \
            len(native) != 6 * EVAL_FRAMES:
        problems.append(f"native preprocess calls {len(native)}")
    if len(frames) != EVAL_FRAMES or tokens != [
            f"tok{i}" for i in range(EVAL_FRAMES)]:
        problems.append(f"{len(frames)} frames, tokens {tokens}")
    bad = [f for f, c in enumerate(per_frame) if c != WANT_LAUNCHES]
    if bad:
        problems.append(f"launches {per_frame[bad[0]]} in frame {bad[0]}, "
                        f"want {WANT_LAUNCHES}")
    if seen.get("scene_ids") != want_scenes:
        problems.append(f"scene ids {seen.get('scene_ids')}")
    if not keys_ok:
        problems.append(f"metric keys {keys}")
    if not all(identical):
        problems.append(f"decode differs on rerun: {identical}")
    if not finite:
        problems.append("non-finite predictions")
    if problems:
        raise AssertionError(f"eval phase: {problems}")
    del model
    free_cuda(torch)


# the bench's launches a frame under SIMPB_FUSED_TRUNK=0: the module
# trunk, whose only kernel is K1
MODULE_TRUNK_LAUNCHES = {"maxpool_3x3_s2": 1, "deformable_aggregation": 3,
                         "msda_patch_sel": 3}


def phase_bench(torch):
    """The port's bench with a short window, as it serves by default (the
    fused trunk) and under SIMPB_FUSED_TRUNK=0 (the module trunk), the
    launch counts set to 0 just before and read just after each; prints
    each JSON line."""
    from simpb_tpu_torch import bench
    from simpb_tpu_torch.models.detector import uses_fused_trunk
    from simpb_tpu_torch.utils.benchmark import run_benchmark

    for env, want in (({}, WANT_LAUNCHES),
                      ({"SIMPB_FUSED_TRUNK": "0"}, MODULE_TRUNK_LAUNCHES)):
        with environment(**env):
            cfg = bench.config()
        reset_launch_counts()
        fps, stats = run_benchmark(cfg, window=BENCH_WINDOW, batch_size=1,
                                   return_stats=True)
        launches = launch_counts()
        free_cuda(torch)
        emit(bench.result(fps, stats))
        want = {k: 2 * BENCH_WINDOW * n for k, n in want.items()}
        got = {k: n for k, n in launches.items() if n}
        emit(dict(phase="bench", config="simpb_r50_704x256_fast", env=env,
                  trunk_route=("fused" if uses_fused_trunk(cfg) else
                               "module"),
                  trunk=cfg.compute_dtype, head=cfg.head_dtype,
                  window=BENCH_WINDOW, fps=fps,
                  peak_hbm_bytes=stats["peak_hbm_bytes"], launches=got))
        if not fps > 0 or not stats["peak_hbm_bytes"]:
            raise AssertionError(f"bench {env}: fps {fps}, stats {stats}")
        if got != want:
            raise AssertionError(f"bench {env}: launches {got}, want "
                                 f"{want}")


PROFILE_FRAMES = 4  # profiled stream frames (the tool's default)
PROFILE_STEPS = 2  # profiled training steps
TOOLS_BENCH_FRAMES = 16  # the benchmark CLI's window (one warm, one timed)
EXPORT_FRAMES = 3  # frames through the exported artifact
ENCODER_FRAMES = 3  # cold + stream frames of each encoder config
ENCODER_CHUNK = 2048  # queries a chunk of kernel D's plain reference
# the encoder's configs: (share_encoder2d, decouple_attn and _2d)
ENCODER_CONFIGS = ((False, True), (True, False))


def phase_profile(torch):
    """`python -m simpb_tpu_torch.tools.profile` and its `--train`, run
    in this process: each prints its table, total device ms and window
    ms. The launches it counts in the trace (the kernel each wrapper
    launches once a call) must equal the wrappers' counters over the
    window, and be JAX's profiled frame's (K1 1, DFA 3, exact MSDA 3) and
    `--config r50`'s step's (`want_train_launches`) per frame or step."""
    import tempfile

    from simpb_tpu_torch.tools import profile

    modes = (("serve", ["--frames", str(PROFILE_FRAMES)],
              {"maxpool_3x3_s2": 1, "deformable_aggregation": 3,
               "msda": 3}),
             ("train", ["--train", "--frames", str(PROFILE_STEPS)],
              want_train_launches(train_config("r50"))))
    with tempfile.TemporaryDirectory() as tmp:
        for mode, argv, want in modes:
            res = profile.run(profile.parse_args(["--out", tmp] + argv))
            n = res["frames"]
            got = {k: v / n for k, v in res["wrapper_launches"].items()}
            emit(dict(phase="profile", mode=mode, config=res["config"],
                      batch_size=res["batch_size"], frames=n,
                      total_device_ms=res["total_device_ms"],
                      window_ms=res["window_ms"],
                      idle_share=res["idle_share"],
                      wrapper_launches=res["wrapper_launches"],
                      kernel_launches=res["kernel_launches"],
                      top=res["top"]))
            if got != want:
                raise AssertionError(f"profile {mode}: launches {got} a "
                                     f"frame, want {want}")
            if res["kernel_launches"] != res["wrapper_launches"]:
                raise AssertionError(
                    f"profile {mode}: the trace counts "
                    f"{res['kernel_launches']}, the wrappers "
                    f"{res['wrapper_launches']}")
            free_cuda(torch)


def phase_tools_bench(torch):
    """`python -m simpb_tpu_torch.tools.benchmark --config r50-fast` in
    this process (JAX's tool's config: the module trunk, trunk and head
    bf16), the launch counts set to 0 just before and read just after:
    K1 1, DFA 3, MSDA-sel 3 a frame over both windows."""
    from simpb_tpu_torch.tools import benchmark

    reset_launch_counts()
    line = benchmark.main(["--config", "r50-fast", "--frames",
                           str(TOOLS_BENCH_FRAMES)])
    got = {k: n for k, n in launch_counts().items() if n}
    free_cuda(torch)
    want = {k: 2 * TOOLS_BENCH_FRAMES * n
            for k, n in MODULE_TRUNK_LAUNCHES.items()}
    emit(dict(phase="tools_bench", line=line, launches=got))
    if not line["six_cam_fps_per_chip"] > 0 or got != want:
        raise AssertionError(f"tools_bench: {line}, launches {got}, want "
                             f"{want}")


def plain_refused():
    """Bind every kernel's plain version to a function that raises, for
    the duration: an artifact run on the card must reach none."""
    from simpb_tpu_torch.ops import conv_fused, sampling

    def refuse(name):
        def make(_):
            def call(*args, **kwargs):
                raise AssertionError(f"{name} ran on the card")
            return call
        return make

    names = ((conv_fused, ("maxpool_3x3_s2_plain", "bottleneck_plain",
                           "conv3x3_bias_plain")),
             (sampling, ("deformable_aggregation_plain",
                         "_msda_patch_sel_plain", "msda_plain",
                         "_msda_patch_levels_plain",
                         "msda_hybrid_exact_plain", "hybrid_selection_plain",
                         "msda_clamp_demand_plain")))
    return rebound(*((mod, n, refuse(n)) for mod, ns in names for n in ns))


def phase_export(torch):
    """`python -m simpb_tpu_torch.tools.export --config r50-fast
    --fused-trunk --smoke` in this process (the flagship, trunk and head
    bf16, random weights of seed 0): the export's seconds and the
    artifact's bytes, the CLI's two-frame smoke, then EXPORT_FRAMES
    frames through the loaded artifact against the model's step, every
    output bit for bit, with every plain version refused while the
    artifact runs and the launch counts of each of its frames
    1/4/12/4/3/3 (WANT_LAUNCHES)."""
    import tempfile

    from simpb_tpu_torch.tools import export as export_cli
    from simpb_tpu_torch.utils.export import make_serving_fn

    with tempfile.TemporaryDirectory() as tmp:
        res = export_cli.run(export_cli.parse_args([
            "--config", "r50-fast", "--fused-trunk", "--smoke", "--out",
            os.path.join(tmp, "simpb_r50_fast.pt2")]))
    cfg, model, served = res["cfg"], res["model"], res["served"]
    hc = cfg.head
    step = make_serving_fn(cfg, model)
    imgs, proj, t2c, dt = stream_inputs(torch, cfg, EXPORT_FRAMES - 1)
    ours = theirs = served.init_temporal(1, hc.num_temp_instances,
                                         hc.num_anchor, hc.embed_dims)
    counts, same, art_ms, model_ms = [], [], [], []
    for img in imgs:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_refused(), torch.inference_mode():
            out = served(img, proj, dt, t2c, ours)
        torch.cuda.synchronize()
        art_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append({k: n for k, n in launch_counts().items() if n})
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = step(img, proj, dt, t2c, theirs)
        torch.cuda.synchronize()
        model_ms.append((time.perf_counter() - t0) * 1e3)
        same.append(all(torch.equal(out[k], ref[k]) for k in out
                        if k != "temporal") and all(
            torch.equal(a, b) for a, b in zip(out["temporal"],
                                              ref["temporal"])))
        ours, theirs = out["temporal"], ref["temporal"]
    emit(dict(phase="export", config="simpb_r50_704x256_fast",
              fused_trunk=True, trunk=cfg.compute_dtype, head=cfg.head_dtype,
              export_seconds=res["seconds"], artifact_bytes=len(res["data"]),
              frames=len(imgs), bit_identical=same,
              launches_per_frame=counts, artifact_frame_ms=art_ms,
              model_frame_ms=model_ms,
              valid_last_frame=int(out["valid"].sum().item()),
              top_score_last_frame=float(out["scores"][0, 0].item())))
    del res, model, served, step
    free_cuda(torch)
    if not all(same):
        raise AssertionError(f"export: artifact frames differ from the "
                             f"model's: {same}")
    if any(c != WANT_LAUNCHES for c in counts):
        raise AssertionError(f"export: launches {counts}, want "
                             f"{WANT_LAUNCHES} a frame")


def encoder_config(share, decouple, dtype="bfloat16"):
    """The flagship with one encoder layer (the JAX test's setting) and
    the decoupled attention on or off, trunk and head in `dtype`."""
    import dataclasses

    cfg = flagship(dtype, dtype)
    return dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, encoder2d_layers=1, share_encoder2d=share,
        decouple_attn=decouple, decouple_attn2d=decouple))


def msda_plain_grads(torch, value, ss, loc, attw, gs, gw,
                     chunk=ENCODER_CHUNK):
    """`msda_backward_plain` over query chunks (the whole column's
    autograd does not fit the card): `msda_plain`'s arithmetic on an fp32
    leaf of the values with the roundings of their type; each query's
    location and weight gradients from its chunk, the value gradient
    summed over the chunks in fp32 and rounded once to the value's type,
    as the plain version rounds it."""
    from simpb_tpu_torch.ops import sampling

    b, total, c = value.shape
    q, heads, _, points = loc.shape[1:5]
    table = value.detach().reshape(b * total, c).float().requires_grad_()
    base = (torch.arange(b, device=value.device) * total)[:, None]
    g_table, g_loc, g_attw = torch.zeros_like(table), [], []
    for q0 in range(0, q, chunk):
        n = min(chunk, q - q0)
        l_ = loc[:, q0:q0 + n].detach().requires_grad_()
        a_ = attw[:, q0:q0 + n].detach().requires_grad_()
        acc = torch.zeros((b, n, heads, c), device=value.device)
        acc_w = torch.zeros((b, n, heads), device=value.device)
        for lvl, (h, w) in enumerate(ss.shapes):
            smp, mass = sampling._msda_level(
                table, base + ss.start_indices[lvl], h, w,
                l_[:, :, :, lvl].reshape(b, -1, 2), value.dtype)
            w_l = a_[:, :, :, lvl].float()
            acc = acc + torch.einsum("bqhpc,bqhp->bqhc", smp.reshape(
                b, n, heads, points, c), w_l)
            acc_w = acc_w + torch.einsum("bqhp,bqhp->bqh", w_l, mass.reshape(
                b, n, heads, points))
        gt, gl, ga = torch.autograd.grad(
            [acc, acc_w], [table, l_, a_],
            [gs[:, q0:q0 + n], gw[:, q0:q0 + n]])
        g_table += gt
        g_loc.append(gl)
        g_attw.append(ga)
    return (g_table.to(value.dtype).reshape(value.shape),
            torch.cat(g_loc, 1), torch.cat(g_attw, 1))


def phase_encoder2d(torch):
    """The flagship with the 2D encoder (ENCODER_CONFIGS: unshared with
    the decoupled attention, shared with it off), ENCODER_FRAMES frames
    each: launches 1/4/12/4/3/3 plus the encoder's exact MSDA a frame;
    every frame's last-layer outputs through the kernels and through the
    plain route (trunk, DFA, MSDA-sel and the encoder's MSDA plain) on the
    same carried state, both held against the fp32 plain route as the
    parity phase holds them. Then the exact MSDA kernel on the encoder's
    recorded call ([6, 14,960, 256] values, 14,960 queries a camera row)
    against `msda_plain` at EXACT_TOL in bf16 and fp32, and kernel D there
    against the plain gradients (`msda_plain_grads`) at GRAD_TOL, both
    repeated bit for bit. Returns each kernel's `encoder2d` entry for the
    kernels line."""
    from simpb_tpu_torch.models import encoder2d
    from simpb_tpu_torch.ops import sampling
    from simpb_tpu_torch.training.evaluate import build_model

    keys = ("prediction", "classification", "quality")
    want = dict(WANT_LAUNCHES, msda=1)
    rel = lambda a, r: ((a - r).norm() / r.norm()).item()
    plain_msda = lambda *a, **k: sampling.msda_plain(*a, **k)
    calls = []
    for share, decouple in ENCODER_CONFIGS:
        cfg = encoder_config(share, decouple)
        model = build_model(cfg, device="cuda", seed=0)
        model32 = build_model(encoder_config(share, decouple, "float32"),
                              device="cuda", seed=0)
        imgs, proj, t2c, dt = stream_inputs(torch, cfg, ENCODER_FRAMES - 1)
        state, frames, counts = None, [], []
        for f, img in enumerate(imgs):
            kw = {} if state is None else dict(
                temporal=state, time_interval=dt, temp2cur=t2c)
            reset_launch_counts()
            record = (rebound((encoder2d, "msda", lambda fn: lambda *a, **k:
                               calls.append(a) or fn(*a, **k)))
                      if not calls and f == len(imgs) - 1
                      else contextlib.nullcontext())
            with record, torch.inference_mode():
                out = model(img, proj, **kw)
            counts.append({k: n for k, n in launch_counts().items() if n})
            with plain_route(), rebound(
                    (encoder2d, "msda", lambda _: plain_msda)), \
                    torch.inference_mode():
                plain16 = model(img, proj, **kw)
                plain32 = model32(img, proj, **kw)
            line = {}
            for key in keys:
                k16, p16, p32 = (o[key][-1].float()
                                 for o in (out, plain16, plain32))
                ek, ep = rel(k16, p32), rel(p16, p32)
                line[key] = dict(kernels=ek, plain_bf16=ep,
                                 kernels_vs_plain_bf16=rel(k16, p16), ok=bool(
                    torch.isfinite(k16).all())
                    and ek <= BF16_SLICE_RATIO * ep + BF16_SLICE_FLOOR)
            frames.append(line)
            state = out["temporal_state"]
        emit(dict(phase="encoder2d", config="simpb_r50_704x256_fast",
                  encoder2d_layers=1, share_encoder2d=share,
                  decouple_attn=decouple, trunk="bfloat16", head="bfloat16",
                  reference="fp32 plain route", ratio=BF16_SLICE_RATIO,
                  floor=BF16_SLICE_FLOOR, rel_l2_vs_fp32_plain=frames,
                  launches_per_frame=counts))
        del model, model32, out, plain16, plain32, state
        free_cuda(torch)
        bad = [(f, k) for f, line in enumerate(frames)
               for k, v in line.items() if not v["ok"]]
        if bad or any(c != want for c in counts):
            raise AssertionError(f"encoder2d (share {share}): frames {bad} "
                                 f"off, launches {counts}, want {want}")

    # the exact MSDA kernel and kernel D at the encoder's shape
    kernels = {n: (w, p, tpu) for n, w, p, tpu in sampling.KERNELS}
    # the recorded tensors were made under inference mode: copies for
    # autograd
    value, ss, loc, attw = calls[0][:4]
    value, loc, attw = (t.clone() for t in (value, loc, attw))
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        args = (value.to(dtype), ss, loc, attw)
        wrapper, plain, _ = kernels["msda"]
        line = hold_case(torch, f"encoder2d_call_{dname}", "msda", wrapper,
                         plain, args, {"raw_heads": True}, EXACT_TOL[dname],
                         msda_exact_work(args),
                         library=grid_sample_chain(*args))
        gs = torch.randn(loc.shape[:3] + (value.shape[-1],), generator=gen,
                         device="cuda")
        gw = torch.randn(loc.shape[:3], generator=gen, device="cuda")
        bargs = args + (gs, gw)
        got = sampling.msda_backward(*bargs)
        again = sampling.msda_backward(*bargs)
        ref = msda_plain_grads(torch, *bargs)
        ok, recs = grad_check(got, ref)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        byts, ops = msda_exact_bwd_work(bargs)
        bound, bound_by = sampling_bound("msda_backward", dname, byts, ops)
        dline = dict(phase="encoder2d_grad", case=f"encoder2d_call_{dname}",
                     name="msda_backward", dtype=dname, ok=ok,
                     deterministic=same, grads=recs,
                     ms=cuda_ms(lambda: sampling.msda_backward(*bargs),
                                iters=3),
                     plain_ms=cuda_ms(lambda: msda_plain_grads(
                         torch, *bargs), iters=1),
                     library_ms=cuda_ms(grid_sample_chain_backward(
                         *args, gs), iters=3),
                     bound_ms=bound, bound_by=bound_by)
        emit(dline)
        if not (ok and same):
            raise AssertionError(f"encoder2d kernel D ({dname}): {recs}, "
                                 f"repeat bit-identical {same}")
        if dtype == torch.bfloat16:  # the encoder's own type
            rows["msda"] = {k: line[k] for k in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by")}
            rows["msda_backward"] = {k: dline[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        del got, again, ref, gs, gw
        free_cuda(torch)
    for row in rows.values():
        row.update(launches_per_frame=1, shape=[6, 14960, 256])
    return rows


TRAIN_STEPS = 4  # timed training steps after one warm step
TRAIN_BS = 4  # TrainConfig.batch_size, the reference's per-GPU batch
# kernels B and C against their plain versions (fp32 sums of the same
# rounded forward quantities, rounded once), element by element:
# |got - plain| <= rel * |plain| + frac * max |plain|. The kernels' fp32
# sums run in another order than the plain version's (frac, in both
# types); a bf16 gradient then rounds the two sums once each, so they may
# land one bf16 step apart, at most 2^-7 of the value (rel)
GRAD_TOL = {"float32": (0.0, 1e-5), "bfloat16": (2.0 ** -7, 1e-5)}


def grad_check(got, ref):
    """Each gradient of `got` against the plain version's `ref` at
    GRAD_TOL: (ok, one record a gradient with its largest error, the
    plain gradient's largest and median nonzero magnitudes, and its
    worst share of the bound)."""
    ok, recs = True, []
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{g.shape}/{g.dtype} vs {r.shape}/"
                                 f"{r.dtype}")
        rel, frac = GRAD_TOL[str(g.dtype).split(".")[-1]]
        err = (g.float() - r.float()).abs()
        mag = r.float().abs()
        top = mag.max().item()
        nz = mag[mag > 0]
        bound = rel * mag + frac * max(top, 1e-30)
        worst = (err / bound).max().item()
        recs.append(dict(max_abs_err=err.max().item(), max_abs_plain=top,
                         median_nonzero_plain=(nz.median().item()
                                               if nz.numel() else 0.0),
                         worst_share_of_bound=worst))
        ok = ok and worst <= 1.0
    return ok, recs


# the training CLI's configs the train phases run, by `--config`
TRAIN_CONFIGS = {"r50-fast": "simpb_r50_704x256_fast",
                 "r50": "simpb_r50_704x256",
                 "r101-fast": "simpb_r101_1408x512_fast",
                 "r101": "simpb_r101_1408x512"}


def train_config(config="r50-fast"):
    """The config `tools/train.py --config <config>` trains: trunk bf16
    (--bf16), head fp32, backbone remat, grid mask and dropout on."""
    from simpb_tpu_torch.tools import train as train_cli

    return train_cli.build_config(train_cli.parse_args(
        ["--ann-file", "unused", "--config", config]))


def want_train_launches(cfg):
    """Launches a training step: no trunk kernel; DFA and the 2D
    cross-attention's op (MSDA-sel windowed, exact MSDA otherwise)
    forward and backward once per op; one assignment for all refine3d
    layers (3D targets), one for all refine2d layers (2D targets) and
    one for the DN anchors."""
    order = cfg.head.operation_order
    n3d, n2d = order.count("refine3d"), order.count("refine2d")
    msda = "msda_patch_sel" if cfg.head.msda_patch_mode else "msda"
    return {"deformable_aggregation": order.count("deformable"),
            "deformable_aggregation_backward": order.count("deformable"),
            msda: order.count("qg_cross_attn"),
            f"{msda}_backward": order.count("qg_cross_attn"),
            "assignment": (n3d > 0) + (n2d > 0) + 1}


def train_loss_keys(cfg):
    order = cfg.head.operation_order
    keys = {"loss", "loss_dense_depth"}
    for i in range(order.count("refine3d")):
        keys |= {f"loss_{k}3d_{i}" for k in ("cls", "box", "cns", "yns")}
        keys |= {f"loss_{k}3d_dn_{i}" for k in ("cls", "box")}
    for i in range(order.count("refine2d")):
        for dn in ("", "dn_"):
            keys |= {f"loss_{k}2d_{dn}{i}"
                     for k in ("cls", "iou", "box", "alpha")}
    return keys


def train_recording(calls):
    """Append (name, args, kwargs) of every call of the step's kernel
    wrappers (DFA's and MSDA-sel's forwards, the three sampling
    backwards, the assignments of the 3D, 2D and DN targets, all made in
    targets3d) to `calls`, then run the wrapper."""
    from simpb_tpu_torch.models import dfa
    from simpb_tpu_torch.ops import sampling
    from simpb_tpu_torch.training import targets3d

    def recorder(name):
        def make(fn):
            def call(*args, **kwargs):
                calls.append((name, args, kwargs))
                return fn(*args, **kwargs)
            return call
        return make

    return rebound(
        (dfa, "deformable_aggregation", recorder("deformable_aggregation")),
        (sampling, "_msda_patch_sel", recorder("msda_patch_sel")),
        (sampling, "deformable_aggregation_backward",
         recorder("deformable_aggregation_backward")),
        (sampling, "msda_patch_sel_backward",
         recorder("msda_patch_sel_backward")),
        (sampling, "msda_backward", recorder("msda_backward")),
        (targets3d, "batched_assignment", recorder("assignment")))


def phase_train(torch, config="r50-fast", phase="train", steps=TRAIN_STEPS):
    """The training step of `tools/train.py --config <config>` at full
    width: bs 4 x 6 cameras, one warm step, then `steps` steps carrying
    the temporal and DN state, the launch counts set to 0 just before
    and read just after. Returns (launches, recorded calls of the last
    step)."""
    from simpb_tpu_torch.configs.base import TrainConfig
    from simpb_tpu_torch.training.train_step import (
        build_train_model, build_train_step, create_train_state,
        init_temporal,
    )
    from simpb_tpu_torch.utils.synthetic import (
        batch_to_torch, synthetic_train_batch,
    )

    cfg = train_config(config)
    tc = TrainConfig()
    model = build_train_model(cfg, device="cuda", seed=0)
    state = create_train_state(model, tc)
    step = build_train_step(model, tc)
    batch = batch_to_torch(synthetic_train_batch(cfg, TRAIN_BS, seed=0),
                           "cuda")
    temporal, dn_state = init_temporal(cfg, TRAIN_BS, device="cuda")
    watch = ("head.anchor", "img_backbone.conv1.weight",
             "img_backbone.layer4_2.conv3.weight",
             "head.fc_before.weight")
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone() for n in watch}
    frozen = params["head.instance_feature"].detach().clone()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, temporal, dn_state, m = step(state, batch, temporal, dn_state, 0)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    want = want_train_launches(cfg)
    keys = train_loss_keys(cfg)
    calls, times, parts, losses, counts = [], [], [], [], []
    reset_launch_counts()
    for i in range(steps):
        last = i == steps - 1
        marks = []
        before_c = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (train_recording(calls) if last else contextlib.nullcontext()):
            state, temporal, dn_state, m = step(state, batch, temporal,
                                                dn_state, 0, marks=marks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        after_c = launch_counts()
        counts.append({k: after_c[k] - before_c[k] for k in after_c
                       if after_c[k] - before_c[k]})
        ev = dict(marks)
        parts.append({k: ev[a].elapsed_time(ev[k]) for a, k in (
            ("start", "forward"), ("forward", "backward"),
            ("backward", "optimizer"))})
        loss = float(m["loss"])
        losses.append(loss)
        if not all(torch.isfinite(v).all() for v in m.values()):
            raise AssertionError(f"step {i}: a non-finite loss")
        if set(m) != keys:
            raise AssertionError(f"step {i}: loss keys differ: missing "
                                 f"{sorted(keys - set(m))[:6]}, extra "
                                 f"{sorted(set(m) - keys)[:6]}")
        if dn_state is None:
            raise AssertionError(f"step {i}: no DN state carried")
        if counts[-1] != want:
            raise AssertionError(f"step {i}: launches {counts[-1]}, want "
                                 f"{want}")
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    moved = {n: float((params[n].detach() - before[n]).abs().max())
             for n in watch}
    if min(moved.values()) <= 0:
        raise AssertionError(f"parameters did not move: {moved}")
    if not torch.equal(params["head.instance_feature"], frozen):
        raise AssertionError("the frozen instance feature moved")
    srt = sorted(times)
    med = lambda k: statistics.median(p[k] for p in parts)
    emit(dict(phase=phase, config=TRAIN_CONFIGS[config],
              msda_patch_mode=cfg.head.msda_patch_mode,
              dfa_gather_capacity=cfg.head.dfa_gather_capacity,
              msda_gather_capacity=cfg.head.msda_gather_capacity,
              trunk="bfloat16", head="float32", batch_size=TRAIN_BS,
              input_size=list(cfg.input_size),
              backbone_depth=cfg.backbone_depth, stem_s2d=cfg.stem_s2d,
              backbone_remat=cfg.backbone_remat,
              grid_mask=cfg.use_grid_mask, drop_out=cfg.head.drop_out,
              steps=steps, warm_step_ms=warm_ms, step_ms=times,
              step_ms_median=statistics.median(times),
              step_ms_range=[srt[0], srt[-1]],
              forward_ms_median=med("forward"),
              backward_ms_median=med("backward"),
              optimizer_ms_median=med("optimizer"), parts_ms=parts,
              max_memory_allocated=peak, loss=losses,
              loss_keys=len(keys), launches=launches,
              launches_per_step=counts[-1], params_moved=moved,
              calls_recorded=len(calls)))
    del model, state, batch, temporal, dn_state, m
    free_cuda(torch)
    return launches, calls


def lsa_work(args):
    """(bytes, operations) an assignment call must move and do at least:
    the valid rows of its cost matrices read once (a padded row's cost is
    the pad cost, read by nobody), the row flags, the columns written; a
    search from each row reads that row at least (a compare and an add a
    column)."""
    cost, valid = args[:2]
    b, r, c = cost.shape
    return int(valid.sum()) * c * 4 + b * r * 5, 2 * b * r * c


def argmin_link_us(torch, cols: int) -> float:
    """Device microseconds of one link of a chain of dependent warp
    argmins, the step reduction of kernel A's instance for `cols`
    columns (an add a slot, the lane tree and two redux minima), from
    two chain lengths (the slope drops the launch)."""
    from simpb_tpu_torch.ops import _kernels

    lib = _kernels.load("assignment")
    out = torch.empty(1, device="cuda")
    stream = _kernels.stream_ptr(out)
    times = {}
    for n in (1 << 16, 1 << 17):
        for timed in (False, True):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _kernels.check(lib.simpb_lsa_argmin_chain(
                _kernels.ptr(out), n, cols, stream), "argmin chain")
            end.record()
            end.synchronize()
            if timed:
                times[n] = start.elapsed_time(end)
    return (times[1 << 17] - times[1 << 16]) / (1 << 16) * 1e3


def dfa_bwd_work(sampling, args, kwargs):
    """(bytes, operations) of kernel B at least: the forward's reads
    (`dfa_work`, less the forward's output, which the backward does not
    write) and grad_out, the three dense gradients written once, each in
    its input's dtype; about 30 operations per (counted slot, level,
    channel)."""
    col, ss, pts, wts, gout = args[:5]
    byts, ops = dfa_work(sampling, (col, ss, pts, wts),
                         dict(gather_capacity=args[5]))
    byts -= pts.shape[0] * pts.shape[1] * col.shape[3] * 4
    byts += gout.numel() * 4 + col.numel() * col.element_size() + \
        (pts.numel() + wts.numel()) * pts.element_size()
    return byts, ops * 30 // 11


def dfa_bwd_parts_ms(sampling, args):
    """Device ms of kernel B's three launches apart (B0 the rank scan, B1
    the per-anchor pass, B2 the feature gradient), each queued alone on
    one set of buffers (B2 reads the records that B0 and B1 left)."""
    col, ss, pts, wts, gout, cap, thr = args
    plan = sampling.plan_dfa_backward(
        col.shape[0], col.shape[1], pts.shape[1], pts.shape[2],
        wts.shape[-1], col.shape[3], cap, ss.shapes)
    bufs = sampling._dfa_bwd_buffers(col, pts, wts, plan)
    go = gout.float().contiguous()
    launch = lambda stages: sampling._dfa_bwd_launch(col, pts, wts, thr, go,
                                                     plan, bufs, stages)
    launch(7)
    return {part: device_ms(lambda: launch(stage), iters=3)
            for part, stage in (("B0", 1), ("B1", 2), ("B2", 4))}


def msda_bwd_work(sampling, args):
    """(bytes, operations) of kernel C at least: the forward's reads, the
    sampled and wsum gradients, the dense value gradient written once and
    the location and weight gradients; 4 operations per (query, level,
    head, pixel, channel): a pixel's gradient dot and its value
    gradient."""
    value, ss, loc, attw, heads, ph, pw, k = args[:8]
    byts, ops = msda_work(sampling, args[:8])
    gs = args[8]
    byts += gs.numel() * 4 + value.numel() * value.element_size() + \
        (loc.numel() + attw.numel()) * 4
    return byts, 2 * ops


def msda_exact_bwd_work(args):
    """(bytes, operations) of kernel D at least: the exact forward's
    reads (`msda_exact_work`: the distinct value rows its samples read),
    the sampled and wsum gradients, the dense value gradient written once
    and the location and weight gradients; 25 operations per (query,
    head, sample, channel): the sample again (7), its dot with the
    gradient (2), the four corner-weight derivatives (8) and the four
    corners' value gradients (8)."""
    value, _, loc, attw, gs, gw = args
    byts, ops = msda_exact_work(args[:4])
    byts += ((gs.numel() + gw.numel() - gw.numel() * (value.shape[-1] + 1))
             * 4 + value.numel() * value.element_size()
             + (loc.numel() + attw.numel()) * 4)
    return byts, ops * 25 // 10


def msda_bwd_parts_ms(sampling, args):
    """Device ms of kernel D's launches apart: D1 (the per-query pass),
    the bin pass (count, scan, fill), D2 over the tiles whose lists fit a
    chunk (`D2_tiles`), D2 over the crowded tiles, split over clusters
    with their merge (`D2_split`), both D2 launches (`D2`), and both over
    each level's tiles alone (`D2_<h>x<w>`) and over its tile (0, 0) alone
    (`D2_<h>x<w>_tile00`, where every padded slot's samples land), each
    queued alone on one set of buffers (each launch reads what the ones
    before it left)."""
    value, ss, loc, attw, gs, gw = args
    b, _, c = value.shape
    q, heads, _, points = loc.shape[1:5]
    plan = sampling.plan_msda_backward(b, q, heads, points, c, ss.shapes)
    bufs = sampling._msda_bwd_buffers(value, loc, attw, plan)
    gs, gw = gs.float().contiguous(), gw.float().contiguous()
    launch = lambda stages, tiles=None: sampling._msda_bwd_launch(
        value, loc, attw, gs, gw, plan, bufs, stages, tiles)
    launch(15)
    stage = sampling.D_STAGES
    parts = {name: device_ms(lambda: launch(stage[name]), iters=3)
             for name in ("D1", "bin", "D2_tiles", "D2_split")}
    d2 = stage["D2_tiles"] | stage["D2_split"]
    parts["D2"] = device_ms(lambda: launch(d2), iters=3)
    for lvl, (h, w) in enumerate(ss.shapes):
        lo = plan.first[lvl]
        tiles = (lo, lo + -(-h // sampling.B2_TILE) * -(-w // sampling.B2_TILE))
        parts[f"D2_{h}x{w}"] = device_ms(lambda: launch(d2, tiles), iters=3)
        parts[f"D2_{h}x{w}_tile00"] = device_ms(
            lambda: launch(d2, (lo, lo + 1)), iters=3)
    return parts


def grid_sample_chain_backward(value, ss, loc, attw, gs):
    """The yardstick of kernel D: the backward of `grid_sample_chain` (to
    the fp32 value planes, the locations and the weights) at the sampled
    gradient `gs`, its forward run once outside the timed call. Returns a
    callable giving the three gradients."""
    import torch

    v = value.detach().float().requires_grad_(True)
    l_ = loc.detach().requires_grad_(True)
    a = attw.detach().requires_grad_(True)
    out = grid_sample_chain(v, ss, l_, a)()
    return lambda: torch.autograd.grad(out, (v, l_, a), gs,
                                       retain_graph=True)


def grad_cases(torch, sampling, calls, gen, names=(
        "deformable_aggregation_backward", "msda_patch_sel_backward",
        "msda_backward"), synthetic=True):
    """(label, name, args) of the gradient checks of the backward kernels
    `names`: their recorded calls of the last step, then (`synthetic`)
    synthetic full-width cases in fp32 and bf16 (B and C: phase 6's
    inputs with a random output gradient; D: the exact phase's with
    random sampled and wsum gradients)."""
    cases = [(f"step_call_{i}", name, args + tuple(
        kwargs.get(k) for k in ("gather_capacity", "thresholds")
        if name == "deformable_aggregation_backward" and k in kwargs))
        for i, (name, args, kwargs) in enumerate(calls) if name in names]
    for dtype in (torch.float32, torch.bfloat16) if synthetic else ():
        if "msda_backward" in names:
            for label, args in exact_cases(torch, dtype, gen):
                value, ss, loc, attw = args
                gs = torch.randn(loc.shape[:3] + value.shape[-1:],
                                 generator=gen, device="cuda")
                gw = torch.randn(loc.shape[:3], generator=gen,
                                 device="cuda")
                cases.append((f"{label}_bwd", "msda_backward",
                              args + (gs, gw)))
        if not {"deformable_aggregation_backward",
                "msda_patch_sel_backward"} & set(names):
            continue
        for label, name, args, kwargs in synthetic_sampling(torch, dtype,
                                                            gen):
            if f"{name}_backward" not in names:
                continue
            if name == "deformable_aggregation":
                col, ss, pts, wts = args
                cap = kwargs.get("gather_capacity")
                out, thr = sampling._dfa_launch(col, ss, pts, wts, cap)
                gout = torch.randn(out.shape, generator=gen, device="cuda")
                cases.append((label, "deformable_aggregation_backward",
                              (col, ss, pts, wts, gout, cap, thr)))
            else:
                value, ss, loc, attw, heads, ph, pw, k = args
                b, q = loc.shape[:2]
                gs = torch.randn(b, q, heads, value.shape[-1], generator=gen,
                                 device="cuda")
                gw = torch.randn(b, q, heads, generator=gen, device="cuda")
                cases.append((label, "msda_patch_sel_backward",
                              args + (gs, gw)))
    return cases


# the kernels the train phase holds, and those the train_exact phase holds
FAST_TRAIN_KERNELS = ("deformable_aggregation_backward",
                      "msda_patch_sel_backward", "assignment")
EXACT_TRAIN_KERNELS = ("msda_backward",)


def phase_train_kernels(torch, calls, train_launches,
                        names=FAST_TRAIN_KERNELS, synthetic=True):
    """The kernels `names` against their plain versions. The backwards
    (B, C, D) on the last step's recorded calls and (`synthetic`) on
    synthetic cases,
    each launched twice (both must repeat bit for bit; B's three
    launches and D's two, D2 also level by level, are also timed apart;
    D beside the grid_sample chain's backward); A on every problem of
    each recorded call against its plain version (exact col4row; the
    plain version runs on the CPU, counting each matrix's serial
    Dijkstra steps) and against scipy's optimal cost, with its latency
    floor: the longest matrix's steps times one dependent warp argmin.
    Returns the kernels-line entries."""
    import numpy as np
    import scipy.optimize

    from simpb_tpu_torch.ops import sampling
    from simpb_tpu_torch.training import matching

    bwd = {n: (w, p, tpu) for n, w, p, tpu in sampling.BACKWARD_KERNELS}
    summary = {n: dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
                       library_ms=None,
                       bound={"bytes": 0.0, "operations": 0.0},
                       bit_identical=True)
               for n in names}
    parts_step = {}  # device ms a step of B's and D's launches
    gen = torch.Generator(device="cuda").manual_seed(2)
    backwards = tuple(n for n in names if n != "assignment")
    for label, name, args in grad_cases(torch, sampling, calls, gen,
                                        backwards, synthetic):
        wrapper, plain, _ = bwd[name]
        dname = str(args[0].dtype).split(".")[-1]
        before = sampling.launch_counts()[name]
        got = wrapper(*args)
        launched = sampling.launch_counts()[name] - before
        again = wrapper(*args)
        plain_args = args[:6] if name.startswith("deformable") else args
        ref = plain(*plain_args)
        torch.cuda.synchronize()
        same = all(torch.equal(g_, a_) for g_, a_ in zip(got, again))
        close, recs = grad_check(got, ref)
        # neither kernel has atomics: repeats must agree bit for bit
        ok = close and launched == 1 and same
        errs = [r_["max_abs_err"] for r_ in recs]
        frame = label.startswith("step_call")
        ms = cuda_ms(lambda: wrapper(*args), iters=3)
        dev_ms = device_ms(lambda: wrapper(*args), iters=3)
        plain_ms = cuda_ms(lambda: plain(*plain_args), iters=2)
        parts = library_ms = None
        if name.startswith("deformable"):
            byts, ops = dfa_bwd_work(sampling, args, {})
            parts = dfa_bwd_parts_ms(sampling, args)
        elif name == "msda_backward":
            byts, ops = msda_exact_bwd_work(args)
            parts = msda_bwd_parts_ms(sampling, args)
            library_ms = cuda_ms(grid_sample_chain_backward(*args[:5]),
                                 iters=2)
        else:
            byts, ops = msda_bwd_work(sampling, args)
        o_ms = ops / PEAK_OPS["float32"] * 1e3
        b_ms = byts / PEAK_BYTES * 1e3
        bound_by = "bytes" if b_ms >= o_ms else "operations"
        emit(dict(phase="train_grad", case=label, name=name, dtype=dname,
                  grads=recs, tol=GRAD_TOL, ok=ok, launches=launched,
                  bit_identical=same, ms=ms, device_ms=dev_ms,
                  **({"parts_device_ms": parts} if parts else {}),
                  plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=max(b_ms, o_ms), bound_by=bound_by, bytes=byts,
                  operations=ops))
        if not ok:
            raise AssertionError(f"{label}: gradients {recs} beyond "
                                 f"{GRAD_TOL}, {launched} launches, or "
                                 f"repeats bit-identical: {same}")
        s = summary[name]
        s["max_abs_err"] = max([s["max_abs_err"]] + errs)
        s["bit_identical"] = s["bit_identical"] and same
        if frame:
            s["ms"] += ms
            s["device_ms"] += dev_ms
            s["plain_ms"] += plain_ms
            if library_ms is not None:
                s["library_ms"] = (s["library_ms"] or 0.0) + library_ms
            s["bound"][bound_by] += max(b_ms, o_ms)
            for part, t in (parts or {}).items():
                steps = parts_step.setdefault(name, {})
                steps[part] = steps.get(part, 0.0) + t
        del got, again, ref
    out = {name: train_kernel_row(
        name, summary[name], bwd[name][2], train_launches[name],
        parts_step.get(name), bit_identical=summary[name]["bit_identical"])
        for name in backwards}
    if "assignment" not in names:
        return out
    s = summary["assignment"]
    scipy_ms = 0.0
    serial, floors, links = [], [], {}
    for i, (name, args, kwargs) in enumerate(c for c in calls
                                             if c[0] == "assignment"):
        cost, valid = args[:2]
        pad = args[2] if len(args) > 2 else 1e6
        before = matching.launch_counts()["assignment"]
        got = matching.batched_assignment(cost, valid, pad)
        launched = matching.launch_counts()["assignment"] - before
        again = matching.batched_assignment(cost, valid, pad)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        steps = []
        t0 = time.perf_counter()
        ref = matching.batched_assignment_plain(cost.cpu(), valid.cpu(), pad,
                                                steps)
        plain_ms = (time.perf_counter() - t0) * 1e3
        cols = cost.shape[2]
        if cols not in links:
            links[cols] = argmin_link_us(torch, cols)
        serial.append(max(steps))
        floors.append(serial[-1] * links[cols] * 1e-3)
        exact = torch.equal(got.cpu(), ref)
        safe = matching._masked_cost(cost, valid, pad).cpu().double().numpy()
        col = got.cpu().numpy()
        gaps = []
        t0 = time.perf_counter()
        for b in range(safe.shape[0]):
            r, c = scipy.optimize.linear_sum_assignment(safe[b])
            best = safe[b][r, c].sum()
            mine = safe[b][np.arange(safe.shape[1]), col[b]].sum()
            gaps.append(abs(mine - best) / max(abs(best), 1e-30))
        scipy_ms += (time.perf_counter() - t0) * 1e3
        distinct = all(len(set(x.tolist())) == len(x) for x in col)
        ms = cuda_ms(lambda: matching.batched_assignment(cost, valid, pad),
                     iters=3)
        dev_ms = device_ms(lambda: matching.batched_assignment(cost, valid,
                                                               pad), iters=3)
        byts, ops = lsa_work(args)
        b_ms = byts / PEAK_BYTES * 1e3
        o_ms = ops / PEAK_OPS["float32"] * 1e3
        bound_by = "bytes" if b_ms >= o_ms else "operations"
        gap = float(max(gaps))
        ok = bool(launched == 1 and same and exact and distinct
                  and gap <= 1e-5)
        emit(dict(phase="train_assignment", case=f"step_call_{i}",
                  shape=list(cost.shape), valid_rows=int(valid.sum()),
                  launches=launched, deterministic=same,
                  exact=exact, scipy_rel_gap=gap, ok=ok,
                  ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                  library_ms=None, bound_ms=max(b_ms, o_ms),
                  bound_by=bound_by, serial_steps=serial[-1],
                  steps_total=sum(steps), argmin_link_us=links[cols],
                  latency_floor_ms=floors[-1]))
        if not ok:
            raise AssertionError(f"assignment call {i}: launches "
                                 f"{launched}, repeat equal {same}, exact "
                                 f"{exact}, distinct {distinct}, scipy gap "
                                 f"{gap}")
        s["ms"] += ms
        s["device_ms"] += dev_ms
        s["plain_ms"] += plain_ms
        s["bound"][bound_by] += max(b_ms, o_ms)
    emit(dict(phase="train_assignment", scipy_host_ms_step=scipy_ms,
              argmin_link_us=links, serial_steps=serial))
    out["assignment"] = train_kernel_row(
        "assignment", s, matching.KERNELS[0][3], train_launches["assignment"],
        scipy_host_ms=scipy_ms, serial_steps=sum(serial),
        latency_floor_ms=sum(floors))
    return out


def train_kernel_row(name, s, replaces, launches, parts=None, **extra):
    """A training kernel's entry of the kernels line from its summary
    (times and bound summed over one step's calls; `parts`, the device
    ms of its launches apart)."""
    source = "assignment" if name == "assignment" else "sampling"
    return dict(name=name, route="cuda",
                source=f"simpb_tpu_torch/csrc/{source}.cu",
                replaces=replaces, launches=launches,
                max_abs_err=s["max_abs_err"], ms=s["ms"],
                device_ms=s["device_ms"], plain_ms=s["plain_ms"],
                bound_ms=sum(s["bound"].values()),
                bound_by=max(s["bound"], key=s["bound"].get),
                library_ms=s["library_ms"], **extra,
                **({"parts_device_ms": parts} if parts else {}))


TRAIN_CLI_ITERS = 6  # iterations of the training CLI's run
TRAIN_CLI_CKPT = 3  # its checkpoint interval; the resumed run starts here
TRAIN_CLI_FRAMES = 24  # training frames, two scenes
# step 4's loss, resumed against uninterrupted: the step starts from the
# same parameters, moments, stream state and batch, and every kernel of
# the path repeats bit for bit; the rest of the forward is cuDNN and
# eager PyTorch, whose CUDA reductions and index adds may sum in another
# order (fp32 atomics), so the losses may differ by rounding
TRAIN_CLI_LOSS_RTOL = 1e-5


def batch_digest(batch):
    """{key: sha256 of the array's dtype, shape and bytes} of a numpy
    batch (gt_depth's levels one by one)."""
    import hashlib

    import numpy as np

    def one(a):
        a = np.ascontiguousarray(a)
        return hashlib.sha256(str((a.dtype, a.shape)).encode()
                              + a.tobytes()).hexdigest()

    return {k: ([one(x) for x in v] if isinstance(v, list) else one(v))
            for k, v in batch.items()}


def same_state(torch, got, want):
    """Names of the entries of two training states (state, temporal,
    dn_state, prev_pose, best_score) that are not equal bit for bit."""
    import dataclasses

    import numpy as np

    bad = []
    sd_g, sd_w = got["state"].model.state_dict(), want["state"].model.state_dict()
    bad += [k for k in sd_w if not torch.equal(sd_g[k], sd_w[k])]
    for n, (mu, nu) in want["state"].opt_state.items():
        gm, gn = got["state"].opt_state[n]
        if not (torch.equal(gm, mu) and torch.equal(gn, nu)):
            bad.append(f"opt_state.{n}")
    if got["state"].step != want["state"].step:
        bad.append("step")
    for kind in ("temporal", "dn_state"):
        for f in dataclasses.fields(want[kind]):
            if not torch.equal(getattr(got[kind], f.name),
                               getattr(want[kind], f.name)):
                bad.append(f"{kind}.{f.name}")
    for j, (g, w) in enumerate(zip(got["prev_pose"], want["prev_pose"])):
        if (g is None) != (w is None) or (w is not None and not (
                g[0] == w[0] and np.array_equal(g[1], w[1]))):
            bad.append(f"prev_pose[{j}]")
    if len(got["prev_pose"]) != len(want["prev_pose"]):
        bad.append("prev_pose")
    if got["best_score"] != want["best_score"]:
        bad.append("best_score")
    return bad


SRC_HW = (900, 1600)  # the training CLI phases' source images


def memory_datasets():
    """A `NuScenesDataset` maker whose datasets serve decoded frames from
    memory (a pool of 16 seeded SRC_HW frames, one per path by its
    number): the card's machine has no Pillow."""
    import numpy as np

    from simpb_tpu_torch.data.dataset import NuScenesDataset

    pool = np.random.default_rng(0).integers(
        0, 256, (16,) + SRC_HW + (3,), dtype=np.uint8)

    class MemoryImages(NuScenesDataset):
        def load_images(self, paths, dtype=np.float32, scale_hint=None):
            return [pool[self.frame_of[p]].astype(dtype, copy=False)
                    for p in paths]

    def memory(pkl, **kw):
        ds = MemoryImages(pkl, **kw)
        paths = [c["data_path"] for info in ds.data_infos
                 for c in info["cams"].values()]
        ds.frame_of = {p: n % len(pool) for n, p in enumerate(paths)}
        return ds

    return memory


def train_pkl(tmp):
    """The training CLI phases' synthetic training pkl under `tmp`/train:
    TRAIN_CLI_FRAMES frames of six SRC_HW cameras in two scenes, with 2D
    GT and LiDAR files."""
    from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

    os.makedirs(f"{tmp}/train")
    return write_synthetic_infos(f"{tmp}/train", n_frames=TRAIN_CLI_FRAMES,
                                 gap_at=(TRAIN_CLI_FRAMES // 2,),
                                 src_hw=SRC_HW, with_2d=True,
                                 with_lidar=True)


def counting(per_step):
    """A rebinding of `train_step.build_train_step` whose steps append
    their launch counts to `per_step`."""
    def wrap(fn):
        def build(model, tc, *a):
            step = fn(model, tc, *a)

            def counted_step(*args, **kwargs):
                before = launch_counts()
                res = step(*args, **kwargs)
                after = launch_counts()
                per_step.append({k: after[k] - before[k] for k in after
                                 if after[k] - before[k]})
                return res
            return counted_step
        return build
    return wrap


def phase_train_cli(torch):
    """The training CLI (`python -m simpb_tpu_torch.tools.train`) through
    `run`, at full width: `--config r50-fast --batch-size 4` over a
    synthetic 1600x900 training pkl with 2D GT and LiDAR files, decoded
    frames served from memory (no Pillow on the card's machine), with a
    mid-training eval over a 12-frame val pkl; then a second run resumed
    from its first checkpoint. See the module docstring."""
    import math
    import tempfile

    from simpb_tpu_torch.configs.base import TrainConfig
    from simpb_tpu_torch.tools import test as test_cli
    from simpb_tpu_torch.tools import train as train_cli
    from simpb_tpu_torch.training import train_step
    from simpb_tpu_torch.training.checkpoint import restore_checkpoint
    from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

    src_h, src_w = SRC_HW
    bs = TRAIN_BS
    memory = memory_datasets()
    digests, per_step = [], []

    def recorded(fn):
        def make(dataset, items, rng, prev_pose, cfg):
            batch = fn(dataset, items, rng, prev_pose, cfg)
            digests.append(batch_digest(batch))
            return batch
        return make

    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/val")
        pkl = train_pkl(tmp)
        val = write_synthetic_infos(f"{tmp}/val", n_frames=EVAL_FRAMES,
                                    gap_at=(EVAL_FRAMES // 2,),
                                    src_hw=(src_h, src_w), seed=1)
        argv = ["--ann-file", pkl, "--config", "r50-fast", "--batch-size",
                str(bs), "--max-iters", str(TRAIN_CLI_ITERS),
                "--ckpt-interval", str(TRAIN_CLI_CKPT), "--log-interval", "1",
                "--seed", "0", "--work-dir", f"{tmp}/work"]
        args = train_cli.parse_args(argv + [
            "--eval-ann-file", val, "--eval-interval", str(TRAIN_CLI_ITERS),
            "--eval-frames", str(EVAL_FRAMES)])
        cfg = train_cli.build_config(args)
        aug = train_cli.train_aug_conf(cfg, src_h, src_w)
        dataset = memory(pkl, test_mode=False, data_aug_conf=aug,
                         sequences_split_num=2,
                         strides=cfg.strides[: cfg.num_depth_layers])
        eval_dataset = memory(val, test_mode=True, sequences_split_num=1,
                              data_aug_conf=test_cli.eval_aug_conf(
                                  cfg, src_h, src_w))
        sites = ((train_cli, "make_batch", recorded),
                 (train_step, "build_train_step", counting(per_step)))
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with rebound(*sites):
            first = train_cli.run(args, dataset=dataset,
                                  eval_dataset=eval_dataset)
        first_s = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        first_digests, first_steps = digests[:], per_step[:]
        files = sorted(os.listdir(f"{tmp}/work"))

        # the saved state read back into fresh templates on the card
        model = train_step.build_train_model(cfg, device="cuda", seed=1)
        state = train_step.create_train_state(
            model, TrainConfig(batch_size=bs))
        temporal, dn_state = train_step.init_temporal(cfg, bs, "cuda")
        t0 = time.perf_counter()
        state, temporal, dn_state, pose, it, best = restore_checkpoint(
            f"{tmp}/work/ckpt_best", state, temporal, dn_state)
        restore_ms = (time.perf_counter() - t0) * 1e3
        restored_diff = same_state(torch, dict(
            state=state, temporal=temporal, dn_state=dn_state,
            prev_pose=pose, best_score=best), first)
        del model, state, temporal, dn_state
        free_cuda(torch)

        digests.clear()
        per_step.clear()
        resumed_route = dict(dataset.route_counts)
        args2 = train_cli.parse_args(argv + [
            "--resume-from", f"{tmp}/work/ckpt_{TRAIN_CLI_CKPT}",
            "--work-dir", f"{tmp}/work2"])
        with rebound(*sites):
            second = train_cli.run(args2, dataset=dataset)
        second_digests = digests[:]
        second_steps = per_step[:]
        dataset_route = {k: dataset.route_counts[k] - resumed_route[k]
                         for k in resumed_route}

    want = want_train_launches(cfg)
    keys = train_loss_keys(cfg)
    ev = first["evals"][0] if first["evals"] else {}
    eval_launches = {k: launches[k] - sum(s.get(k, 0) for s in first_steps)
                     for k in launches}
    eval_launches = {k: v for k, v in eval_launches.items() if v}
    loss4 = (first["losses"][TRAIN_CLI_CKPT + 1]["loss"],
             second["losses"][TRAIN_CLI_CKPT + 1]["loss"])
    later = {i: (first["losses"][i]["loss"], second["losses"][i]["loss"])
             for i in range(TRAIN_CLI_CKPT + 2, TRAIN_CLI_ITERS + 1)}
    same_batches = [a == b for a, b in zip(
        first_digests[TRAIN_CLI_CKPT:], second_digests)]
    ckpts = {os.path.basename(c["path"]): dict(ms=c["ms"], bytes=c["bytes"])
             for c in first["checkpoints"]}
    steps_ms = first["step_ms"]
    srt = sorted(steps_ms)
    emit(dict(phase="train_cli", config="simpb_r50_704x256_fast",
              trunk="bfloat16", head="float32", batch_size=bs,
              iters=TRAIN_CLI_ITERS, source_hw=[src_h, src_w],
              frames=TRAIN_CLI_FRAMES, seconds=first_s,
              step_ms=steps_ms, step_ms_median=statistics.median(steps_ms),
              step_ms_range=[srt[0], srt[-1]],
              producer_ms=first["producer_ms"],
              producer_ms_median=statistics.median(first["producer_ms"]),
              queue_wait_ms=first["queue_wait_ms"],
              queue_wait_ms_median=statistics.median(first["queue_wait_ms"]),
              max_memory_allocated=peak, checkpoints=ckpts,
              restore_ms=restore_ms, resume_restore_ms=second["restore_ms"],
              eval_frames=ev.get("frames"),
              eval_ms_per_frame=(ev["ms"] / ev["frames"]) if ev else None,
              eval_nds=ev.get("metrics", {}).get("NDS"),
              route_counts=first["route_counts"],
              eval_route_counts=dict(eval_dataset.route_counts),
              resumed_route_counts=dataset_route,
              launches=launches, launches_per_step=first_steps,
              eval_launches=eval_launches,
              loss=[first["losses"][i]["loss"]
                    for i in range(1, TRAIN_CLI_ITERS + 1)],
              resumed_loss=[second["losses"][i]["loss"] for i in range(
                  TRAIN_CLI_CKPT + 1, TRAIN_CLI_ITERS + 1)],
              step4_loss=loss4, step4_rel_diff=abs(loss4[0] - loss4[1])
              / max(abs(loss4[0]), 1e-30), later_losses=later,
              loss_rtol=TRAIN_CLI_LOSS_RTOL,
              resumed_batches_bit_identical=same_batches,
              restored_state_differs=restored_diff[:8], files=files))
    problems = []
    n_samples = TRAIN_CLI_ITERS * bs
    if first["route_counts"] != {"native": n_samples, "pil": 0} or \
            dataset_route != {"native": (TRAIN_CLI_ITERS - TRAIN_CLI_CKPT)
                              * bs, "pil": 0}:
        problems.append(f"routes {first['route_counts']} / {dataset_route}")
    if eval_dataset.route_counts != {"native": EVAL_FRAMES, "pil": 0}:
        problems.append(f"eval routes {eval_dataset.route_counts}")
    if len(first_steps) != TRAIN_CLI_ITERS or any(
            c != want for c in first_steps + second_steps):
        problems.append(f"launches a step {first_steps + second_steps}, "
                        f"want {want}")
    if eval_launches != {k: EVAL_FRAMES * n for k, n in
                         WANT_LAUNCHES.items()}:
        problems.append(f"eval launches {eval_launches}")
    for i, ld in list(first["losses"].items()) + list(
            second["losses"].items()):
        if set(ld) != keys or not all(math.isfinite(v) for v in ld.values()):
            problems.append(f"iter {i}: loss keys or values {ld}")
            break
    if sorted(first["losses"]) != list(range(1, TRAIN_CLI_ITERS + 1)):
        problems.append(f"logged iterations {sorted(first['losses'])}")
    for name in (f"ckpt_{TRAIN_CLI_CKPT}", f"ckpt_{TRAIN_CLI_ITERS}",
                 "ckpt_best"):
        if name not in files:
            problems.append(f"no {name} in {files}")
    if restored_diff:
        problems.append(f"restored state differs: {restored_diff[:8]}")
    if it != TRAIN_CLI_ITERS or best is None:
        problems.append(f"restored iter {it}, best score {best}")
    if len(same_batches) != TRAIN_CLI_ITERS - TRAIN_CLI_CKPT or \
            not all(same_batches):
        problems.append(f"resumed batches {same_batches}")
    if not abs(loss4[0] - loss4[1]) <= TRAIN_CLI_LOSS_RTOL * abs(loss4[0]):
        problems.append(f"step {TRAIN_CLI_CKPT + 1} loss {loss4}")
    if problems:
        raise AssertionError(f"train_cli phase: {problems}")
    del first, second
    free_cuda(torch)


TRAIN_CLI_EXACT_ITERS = 3  # iterations of the training CLI's --config r50


def phase_train_cli_exact(torch):
    """The training CLI's default, `--config r50 --batch-size 4` (exact
    MSDA), through `tools/train.py::run` for TRAIN_CLI_EXACT_ITERS
    iterations over the train_cli phase's synthetic training pkl (frames
    from memory), no eval, the launch counts set to 0 just before and
    read just after: each step's launches (want_train_launches of the
    exact config: 3 of exact MSDA and of kernel D, none of MSDA-sel or
    C), finite losses with the full key set, the final checkpoint
    written."""
    import math
    import tempfile

    from simpb_tpu_torch.tools import train as train_cli
    from simpb_tpu_torch.training import train_step

    memory = memory_datasets()
    per_step = []
    with tempfile.TemporaryDirectory() as tmp:
        pkl = train_pkl(tmp)
        args = train_cli.parse_args([
            "--ann-file", pkl, "--batch-size", str(TRAIN_BS),
            "--max-iters", str(TRAIN_CLI_EXACT_ITERS), "--log-interval",
            "1", "--seed", "0", "--work-dir", f"{tmp}/work"])
        cfg = train_cli.build_config(args)
        dataset = memory(pkl, test_mode=False, sequences_split_num=2,
                         data_aug_conf=train_cli.train_aug_conf(
                             cfg, *SRC_HW),
                         strides=cfg.strides[: cfg.num_depth_layers])
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with rebound((train_step, "build_train_step", counting(per_step))):
            res = train_cli.run(args, dataset=dataset)
        seconds = time.perf_counter() - t0
        launches = {k: n for k, n in launch_counts().items() if n}
        files = sorted(os.listdir(f"{tmp}/work"))
    want = want_train_launches(cfg)
    keys = train_loss_keys(cfg)
    steps_ms = res["step_ms"]
    emit(dict(phase="train_cli_exact", config=TRAIN_CONFIGS[args.config],
              argv_config=args.config, msda_patch_mode=cfg.head.msda_patch_mode,
              trunk="bfloat16", head="float32", batch_size=TRAIN_BS,
              iters=TRAIN_CLI_EXACT_ITERS, seconds=seconds,
              step_ms=steps_ms, step_ms_median=statistics.median(steps_ms),
              producer_ms=res["producer_ms"],
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              launches=launches, launches_per_step=per_step,
              loss=[res["losses"][i]["loss"]
                    for i in sorted(res["losses"])], files=files))
    problems = []
    if args.config != "r50" or cfg.head.msda_patch_mode:
        problems.append(f"default config {args.config}")
    if len(per_step) != TRAIN_CLI_EXACT_ITERS or any(
            c != want for c in per_step):
        problems.append(f"launches a step {per_step}, want {want}")
    if sorted(res["losses"]) != list(range(1, TRAIN_CLI_EXACT_ITERS + 1)):
        problems.append(f"logged iterations {sorted(res['losses'])}")
    for i, ld in res["losses"].items():
        if set(ld) != keys or not all(math.isfinite(v) for v in ld.values()):
            problems.append(f"iter {i}: loss keys or values {ld}")
            break
    if f"ckpt_{TRAIN_CLI_EXACT_ITERS}" not in files:
        problems.append(f"no final checkpoint in {files}")
    if problems:
        raise AssertionError(f"train_cli_exact phase: {problems}")
    del res
    free_cuda(torch)


# --- data parallel (torch.distributed) and the multi-shard evals -------

DDP_WORLD = 2  # train_ddp's and eval_dist's processes, both on cuda:0
DDP_BS = TRAIN_BS // DDP_WORLD  # a rank's batch: rank r takes rows 2r, 2r+1
DDP_STEPS = 3
DDP_SPAWN_TIMEOUT_S = 420  # each spawned process's limit
# train_ddp's parity run (world 2 against world 1, element by element)
# takes the tiny config with the flagship's fast knobs at depth 50, the
# trunk and its BatchNorm in float64 (its outputs rounded to fp32 for
# the fp32 head): at full width the random-weight step is chaotic
# (moving the BatchNorm means by two fp32 ulps in one process moves its
# step-1 losses by several percent: the `spread` that train_ddp prints,
# through near-ties of the assignment, the bank's top-k, the sampling
# capacities and windows), and a random-weight ResNet-50's training
# backward in fp32 amplifies roundings (JAX's own fp32 gradients lie
# 13-30 % of their largest value from float64,
# tests/test_torch_port_train_trunk.py), so the two
# worlds' other orders of summation could not be told from a fault
# there; at the tiny size with a float64 trunk they can
# (tests/test_torch_port_ddp.py fails each planted fault on the same
# comparison). Its learning rate is DDP_PARITY_LR:
# Adam's first update moves every parameter by +-lr whatever its
# gradient's size, so gradients that are rounding noise in both worlds
# would move apart by 2 lr and make steps 2-3 differ by more than their
# own roundings. The timed run is the CLI's own full-width step.
DDP_PARITY_LR = 1e-6
# step 1's reduced gradients against the one process's, element by
# element, head and trunk apart: the relative L2 norm of the difference
# over each group's gradient elements at most DDP_GRAD_REL_L2. The
# worlds sum the BatchNorm statistics, the gradients and the losses in
# other orders (1e-7 of the norm on the CPU at this size, about 7e-4 on
# an H100, where cuDNN's float64 convolutions at 12 and 24 images and the
# fp32 head round apart), and the gradient is not a smooth function of
# those roundings: a ReLU input or a bilinear sample within a rounding of
# its kink passes or blocks its element's gradient in one world and not
# in the other (the whole tiny step's one gap to JAX is such a ReLU
# input, -1.2e-6, ROADMAP C.2). So a single element may jump (the worst
# element's share of its tensor's largest value is printed), while the
# group's gradient as a whole stays put; a planted fault moves it by
# 50 % (averaged gradients) to 490 % (tests/test_torch_port_ddp.py)
DDP_GRAD_REL_L2 = {"head": 1e-2, "trunk": 1e-2}
# the worst element's share counts this share of the group's largest
# gradient in, for gradients that vanish in exact arithmetic (a key bias
# moves every logit of a row alike: both worlds hold rounding noise)
DDP_GRAD_FLOOR = 1e-6
# the parity run's launches a step: the tiny config's 2D cross-attention
# takes `msda_patch`'s per-level branch (levels smaller than the window),
# plain PyTorch on the card, so it launches no MSDA-sel and no C
PARITY_LAUNCHES = {"deformable_aggregation": 3,
                   "deformable_aggregation_backward": 3, "assignment": 3}
DDP_LOSS_RTOL = 1e-4  # the global losses of each step, relative
NCCL_ITERS = 2  # iterations of the training CLI under NCCL
MULTI_SLOTS = 4  # eval_multi's slots, all on cuda:0: bs 4
MULTI_SCENES, MULTI_SCENE_FRAMES = 4, 4
MULTI_TOL = 1e-2  # bf16 head: of each layer-0 output's largest value


def spawn(job, world, tmp, timeout=DDP_SPAWN_TIMEOUT_S):
    """Run `chip_smoke.<job>(rank, world, port, tmp)` in `world` processes
    started together; returns their outputs, or raises with the failing
    rank's last lines. Every process is gone when it returns."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
            f"chip_smoke.{job}(int(sys.argv[1]), {world}, {port}, "
            f"{tmp!r})")
    env = dict(os.environ, SIMPB_NO_TB="1", PYTHONPATH=here)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              cwd=here, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{job} rank {r} exited {p.returncode}:\n"
                                 f"{out[-3000:]}")
    return outs


def join_gloo(world, rank, port):
    """The one-card phases' process group: gloo over the card's tensors
    (NCCL refuses two ranks on one device), set up here, as a caller
    may; `parallel/mesh.py` takes its world from it."""
    import datetime

    import torch
    import torch.distributed as dist

    from simpb_tpu_torch.parallel import mesh

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=300))
    mesh.warm_mesh_collectives()


def state_digest(torch, state):
    """sha256 of the parameters, BatchNorm buffers and Adam moments."""
    import hashlib

    h = hashlib.sha256()
    tensors = list(state.model.state_dict().values()) + [
        t for mu_nu in state.opt_state.values() for t in mu_nu]
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def parity_config():
    """train_ddp's parity config: `simpb_tiny` with the flagship's fast
    knobs (windowed MSDA, capacities), ResNet-50, head fp32, remat, grid
    mask and dropout on (`float64_trunk` then moves the trunk to
    float64)."""
    import dataclasses

    from simpb_tpu_torch.configs.base import simpb_tiny

    cfg = simpb_tiny()
    head = dataclasses.replace(
        cfg.head, msda_patch_mode=True, msda_gather_capacity=6,
        dfa_gather_capacity=256, msda_sel_levels=2)
    return dataclasses.replace(cfg, head=head, backbone_remat=True,
                               compute_dtype="float32",
                               head_dtype="float32")


def float64_trunk(torch, model):
    """The training model's trunk, FPN and depth branch, BatchNorm
    included, in float64; their outputs rounded to fp32 for the head."""
    for mod in (model.img_backbone, model.img_neck, model.depth_branch):
        mod.double()
    model.compute_dtype = torch.float64
    extract = model.extract_feat_train

    def extract_fp32_out(*args, **kwargs):
        col, shapes, depths = extract(*args, **kwargs)
        return col.float(), shapes, [d.float() for d in depths]

    model.extract_feat_train = extract_fp32_out


def ddp_train(torch, bs, rank, impose=None, parity=True):
    """DDP_STEPS training steps on rows rank*bs:(rank+1)*bs of a bs-4
    batch: `simpb_r50_704x256_fast` as the CLI trains it on the train
    phase's batch (`parity` False: the timed run), or parity_config() at
    DDP_PARITY_LR on a tiny synthetic batch (the parity run). In the
    parity run the one process
    (impose None) records its assignment calls and carried state, and a
    rank takes, for each of its cost matrices, the assignment the one
    process made on the nearest of its own, and at each later step its
    carried temporal and DN state (random weights put many predictions
    within a rounding of a tie, which the two worlds would break apart).
    Returns the losses, step 1's reduced gradients (on the host), the
    records, each step's ms and launches, the peak memory and the
    state's digest."""
    import dataclasses
    import math

    from simpb_tpu_torch.configs.base import TrainConfig
    from simpb_tpu_torch.training import targets3d, train_step
    from simpb_tpu_torch.utils.synthetic import (
        batch_to_torch, synthetic_train_batch,
    )

    cfg, tc = train_config("r50-fast"), TrainConfig()
    full = None
    if parity:
        cfg = parity_config()
        tc = dataclasses.replace(tc, lr=DDP_PARITY_LR)
        full = synthetic_train_batch(cfg, TRAIN_BS, seed=3, num_objects=6,
                                     max_gt3d=8, max_gt2d=6)
    model = train_step.build_train_model(cfg, device="cuda", seed=0)
    if parity:
        float64_trunk(torch, model)
    state = train_step.create_train_state(model, tc)
    step = train_step.build_train_step(model, tc)
    if full is None:
        full = synthetic_train_batch(cfg, TRAIN_BS, seed=0)
    lo, hi = rank * bs, (rank + 1) * bs
    batch = batch_to_torch({k: ([x[lo:hi] for x in v] if isinstance(
        v, list) else v[lo:hi]) for k, v in full.items()}, "cuda")
    temporal, dn_state = train_step.init_temporal(cfg, bs, "cuda")
    grads, calls, cost_rel = [], [], [0.0]

    def recording_apply(fn):
        def apply(state, tc, g):
            if not grads:
                grads.append({n: t.detach().cpu() for n, t in g.items()})
            return fn(state, tc, g)
        return apply

    def imposing(fn):
        def assign(cost, row_valid, pad_cost=1e6):
            own = fn(cost, row_valid, pad_cost)
            cost = torch.nan_to_num(cost, posinf=1e9, neginf=-1e9)
            if impose is None:
                calls.append((cost.cpu(), row_valid.cpu(), own.cpu()))
                return own
            rcost, rvalid, rcol = (t.cuda() for t in
                                   impose["calls"][len(calls)])
            calls.append(None)
            out = torch.empty_like(own)
            for i in range(cost.shape[0]):
                diff = (rcost - cost[i]).abs().amax(dim=(1, 2))
                diff[~(rvalid == row_valid[i]).all(dim=1)] = math.inf
                j = int(diff.argmin())
                cost_rel[0] = max(cost_rel[0], float(diff[j]) / max(
                    float(rcost[j].abs().max()), 1e-30))
                out[i] = rcol[j]
            return out
        return assign

    losses, carried, times, counts = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    with (rebound((train_step, "apply_optimizer", recording_apply),
                  (targets3d, "batched_assignment", imposing))
          if parity else contextlib.nullcontext()):
        for s in range(DDP_STEPS):
            if s and impose is not None:
                temporal, dn_state = (
                    type(x)(**{k: v[lo:hi].cuda() for k, v in ref.items()})
                    for x, ref in zip((temporal, dn_state),
                                      impose["carried"][s - 1]))
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, temporal, dn_state, m = step(state, batch, temporal,
                                                dn_state, 0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            after = launch_counts()
            counts.append({k: after[k] - before[k] for k in after
                           if after[k] - before[k]})
            losses.append({k: float(v) for k, v in m.items()})
            carried.append(tuple({f: getattr(x, f).cpu()
                                  for f in x.__dataclass_fields__}
                                 for x in (temporal, dn_state)))
    out = dict(losses=losses, grads=grads[0] if grads else None,
               calls=calls, carried=carried,
               step_ms=times, launches_per_step=counts, cost_rel=cost_rel[0],
               peak=torch.cuda.max_memory_allocated(),
               digest=state_digest(torch, state))
    del model, state, batch, temporal, dn_state, m
    free_cuda(torch)
    return out


def full_width_spread(torch):
    """Step 1 of `simpb_r50_704x256_fast` as the CLI trains it at bs 4 on
    the train phase's batch, twice from the same start: as it is, and
    with every BatchNorm mean moved by two fp32 ulps (x (1 + 2^-22)).
    Returns both loss dicts: how far one process's step moves under a
    rounding, the yardstick for the two worlds' full-width steps."""
    from simpb_tpu_torch.configs.base import TrainConfig
    from simpb_tpu_torch.models import backbone
    from simpb_tpu_torch.training import train_step
    from simpb_tpu_torch.utils.synthetic import (
        batch_to_torch, synthetic_train_batch,
    )

    def moved(x, bn, dtype):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3)) * (1 + 2 ** -22)
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + backbone.BN_EPS) * bn.weight
        y = ((xf - mean[:, None, None]) * mul[:, None, None]
             + bn.bias[:, None, None])
        return y.to(dtype), (mean.detach(), var.detach())

    cfg, tc = train_config("r50-fast"), TrainConfig()
    model = train_step.build_train_model(cfg, device="cuda", seed=0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = batch_to_torch(synthetic_train_batch(cfg, TRAIN_BS, seed=0),
                           "cuda")
    losses = []
    for move in (False, True):
        model.load_state_dict(start)
        state = train_step.create_train_state(model, tc)
        step = train_step.build_train_step(model, tc)
        temporal, dn_state = train_step.init_temporal(cfg, TRAIN_BS, "cuda")
        with (rebound((backbone, "batch_norm_train", lambda fn: moved))
              if move else contextlib.nullcontext()):
            m = step(state, batch, temporal, dn_state, 0)[3]
        losses.append({k: float(v) for k, v in m.items()})
    del model, state, batch, start
    free_cuda(torch)
    return losses


def worst_rel(got, ref, n=4):
    """The n largest relative differences of a loss dict from another."""
    return sorted(((abs(got[k] - v) / max(abs(v), 1e-30), k)
                   for k, v in ref.items()), reverse=True)[:n]


def ddp_eval_dataset(pkl):
    """eval_dist's val set (the eval phase's 12 synthetic 1600x900 frames
    in two scenes, written by phase_ddp), decoded frames from the seeded
    memory pool (no Pillow)."""
    from simpb_tpu_torch.tools.test import eval_aug_conf

    return memory_datasets()(
        pkl, test_mode=True, sequences_split_num=1,
        data_aug_conf=eval_aug_conf(flagship("bfloat16"), *SRC_HW))


def train_ddp_job(rank, world, port, tmp):
    """A rank of train_ddp and then of eval_dist (gloo on cuda:0)."""
    import torch

    from simpb_tpu_torch.parallel import mesh
    from simpb_tpu_torch.training import evaluate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    join_gloo(world, rank, port)
    impose = torch.load(f"{tmp}/reference.pt", weights_only=True)
    res = ddp_train(torch, TRAIN_BS // world, rank, impose)
    if rank == 0:
        torch.save(res.pop("grads"), f"{tmp}/grads_0.pt")
    else:
        res.pop("grads")
    res.pop("calls")
    res.pop("carried")
    res["backend"] = torch.distributed.get_backend()
    # the CLI's own step (bf16 trunk), timed
    timed = ddp_train(torch, TRAIN_BS // world, rank, parity=False)
    res["timed"] = {k: timed[k] for k in ("losses", "step_ms",
                                          "launches_per_step", "peak",
                                          "digest")}

    # eval_dist: one sequence shard a rank, gathered on disk
    cfg = flagship("bfloat16")
    model = evaluate.build_model(cfg, device="cuda", seed=0)
    dataset = ddp_eval_dataset(f"{tmp}/val/infos.pkl")
    per_frame = []
    reset_launch_counts()
    t0 = time.perf_counter()
    with rebound((evaluate, "make_stream_steps", counted_steps(per_frame))):
        got = evaluate.distributed_streaming_eval(model, cfg, dataset,
                                                  f"{tmp}/gather")
    res["eval"] = dict(seconds=time.perf_counter() - t0,
                       launches_per_frame=per_frame,
                       metrics=got[0] if got else None,
                       preds=got[1] if got else None,
                       tokens=got[2] if got else None)
    mesh.shutdown()
    torch.save(res, f"{tmp}/rank_{rank}.pt")


def counted_steps(per_frame):
    """A rebinding of `make_stream_steps` whose steps append their launch
    counts to `per_frame`."""
    def wrap(make):
        def steps(model, cfg):
            def counted(fn):
                def step(*args):
                    before = launch_counts()
                    out = fn(*args)
                    after = launch_counts()
                    per_frame.append({k: after[k] - before[k] for k in after
                                      if after[k] - before[k]})
                    return out
                return step
            return tuple(counted(fn) for fn in make(model, cfg))
        return steps
    return wrap


def nccl_job(rank, world, port, tmp):
    """The training CLI's own `main --multihost` over NCCL (one card a
    rank) for NCCL_ITERS iterations at --batch-size TRAIN_BS, the frames
    served from the memory pool (the class's decode replaced, since
    `main` builds its own dataset)."""
    import zlib

    import numpy as np
    import torch

    from simpb_tpu_torch.data.dataset import NuScenesDataset
    from simpb_tpu_torch.parallel import mesh
    from simpb_tpu_torch.tools import train as train_cli
    from simpb_tpu_torch.training import train_step

    pool = np.random.default_rng(0).integers(
        0, 256, (16,) + SRC_HW + (3,), dtype=np.uint8)
    NuScenesDataset.load_images = lambda self, paths, dtype=np.float32, \
        scale_hint=None: [pool[zlib.crc32(p.encode()) % len(pool)]
                          .astype(dtype) for p in paths]
    seen, per_step = {}, []

    def recording_init(fn):
        def init(*args, **kwargs):
            dev = fn(*args, **kwargs)
            seen.update(backend=torch.distributed.get_backend(),
                        world=mesh.process_count(), device=str(dev))
            return dev
        return init

    with rebound((mesh, "initialize_multihost", recording_init),
                 (train_step, "build_train_step", counting(per_step))):
        res = train_cli.main([
            "--ann-file", f"{tmp}/train/infos.pkl", "--config", "r50-fast",
            "--batch-size", str(TRAIN_BS), "--max-iters", str(NCCL_ITERS),
            "--log-interval", "1", "--work-dir", f"{tmp}/nccl_{world}",
            "--src-h", str(SRC_HW[0]), "--src-w", str(SRC_HW[1]),
            "--multihost", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(world), "--process-id", str(rank)])
    torch.save(dict(seen, losses=res["losses"], step_ms=res["step_ms"],
                    launches_per_step=per_step,
                    peak=torch.cuda.max_memory_allocated(),
                    group_left=not mesh.is_initialized()),
               f"{tmp}/nccl_{world}_{rank}.pt")


def grad_shares(torch, got, ref):
    """Per tensor group ("trunk": img_backbone, img_neck, depth_branch;
    "head"): the relative L2 norm of got - ref over the group's elements,
    and the worst element's max |got - ref| / (max |ref| +
    DDP_GRAD_FLOOR x the group's largest gradient) with its tensor."""
    group = lambda n: "trunk" if n.split(".")[0] in (
        "img_backbone", "img_neck", "depth_branch") else "head"
    top = {n: float(r.abs().max()) for n, r in ref.items()}
    largest, sq_diff, sq_ref, worst = {}, {}, {}, {}
    for n, t in top.items():
        largest[group(n)] = max(largest.get(group(n), 0.0), t)
    for n, r in ref.items():
        g, d = group(n), (got[n].double() - r.double())
        sq_diff[g] = sq_diff.get(g, 0.0) + float((d * d).sum())
        sq_ref[g] = sq_ref.get(g, 0.0) + float((r.double() ** 2).sum())
        share = float(d.abs().max()) / max(
            top[n] + DDP_GRAD_FLOOR * largest[g], 1e-30)
        if share > worst.get(g, (0.0, ""))[0]:
            worst[g] = (share, n)
    return {g: dict(rel_l2=(sq_diff[g] / max(sq_ref[g], 1e-300)) ** 0.5,
                    worst_element_share=worst[g][0], worst_tensor=worst[g][1])
            for g in sq_ref}


def phase_train_ddp(torch, tmp):
    """train_ddp (see the module docstring): the one-process reference
    here, the two ranks spawned (each then runs eval_dist's shard), then
    the training CLI's NCCL run at world 1 (and 2 on two cards)."""
    import math

    t0 = time.perf_counter()
    ref = ddp_train(torch, TRAIN_BS, 0)
    torch.save(dict(calls=ref.pop("calls"), carried=ref.pop("carried")),
               f"{tmp}/reference.pt")
    ref_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    spawn("train_ddp_job", DDP_WORLD, tmp)
    ranks_seconds = time.perf_counter() - t0
    ranks = [torch.load(f"{tmp}/rank_{r}.pt", weights_only=False)
             for r in range(DDP_WORLD)]
    got = torch.load(f"{tmp}/grads_0.pt", weights_only=True)
    shares = grad_shares(torch, got, ref["grads"])
    loss_rel = max(abs(r["losses"][s][k] - ref["losses"][s][k])
                   / max(abs(ref["losses"][s][k]), 1e-30)
                   for r in ranks for s in range(DDP_STEPS)
                   for k in ref["losses"][s])
    want = want_train_launches(train_config("r50-fast"))
    problems = []
    if set(ranks[0]["losses"][0]) != set(ref["losses"][0]):
        problems.append("loss keys differ")
    for run in ("parity", "timed"):
        res = [r if run == "parity" else r["timed"] for r in ranks]
        if res[0]["losses"] != res[1]["losses"]:
            problems.append(f"{run}: the ranks' global losses differ")
        if len({r["digest"] for r in res}) != 1:
            problems.append(f"{run}: parameters, statistics or moments "
                            "differ across the ranks")
        if not all(math.isfinite(v) for v in res[0]["losses"][-1].values()):
            problems.append(f"{run}: non-finite losses")
    for group, sh in shares.items():
        if not sh["rel_l2"] <= DDP_GRAD_REL_L2[group]:
            problems.append(f"{group} gradients: relative L2 "
                            f"{sh['rel_l2']}")
    if not loss_rel <= DDP_LOSS_RTOL:
        problems.append(f"losses {loss_rel} relative")
    for r, res in enumerate(ranks):
        for run, counts, w in (("parity", res["launches_per_step"],
                                PARITY_LAUNCHES),
                               ("timed", res["timed"]["launches_per_step"],
                                want)):
            bad = [c for c in counts if c != w]
            if bad:
                problems.append(f"rank {r} {run} launches {bad[0]}, want "
                                f"{w}")
        if res["backend"] != "gloo":
            problems.append(f"rank {r} backend {res['backend']}")
    timed = [r["timed"] for r in ranks]
    plain, moved = full_width_spread(torch)
    emit(dict(phase="train_ddp",
              config="simpb_r50_704x256_fast (timed); simpb_tiny with its "
              "fast knobs at depth 50, trunk float64 (parity)",
              head="float32", world=DDP_WORLD,
              backend="gloo (set up by chip_smoke: two ranks on one card)",
              device="cuda:0 for both ranks", batch_per_rank=DDP_BS,
              global_batch=TRAIN_BS, steps=DDP_STEPS,
              parity_trunk="float64", parity_lr=DDP_PARITY_LR,
              timed_trunk="bfloat16", timed_lr="TrainConfig()",
              step_ms=[t["step_ms"] for t in timed],
              step_ms_median=[statistics.median(t["step_ms"][1:])
                              for t in timed],
              peak_bytes=[t["peak"] for t in timed],
              timed_losses=[s["loss"] for s in timed[0]["losses"]],
              parity_reference_step_ms=ref["step_ms"],
              parity_rank_step_ms=[r["step_ms"] for r in ranks],
              parity_reference_peak_bytes=ref["peak"],
              parity_rank_peak_bytes=[r["peak"] for r in ranks],
              gradients=shares, grad_rel_l2=DDP_GRAD_REL_L2,
              loss_worst_rel=loss_rel, loss_rtol=DDP_LOSS_RTOL,
              step1_worst_losses=worst_rel(ranks[0]["losses"][0],
                                           ref["losses"][0]),
              full_width_step1=dict(
                  world2_vs_world1=worst_rel(timed[0]["losses"][0], plain),
                  world1_bn_means_moved_2ulp=worst_rel(moved, plain),
                  loss=[plain["loss"], moved["loss"],
                        timed[0]["losses"][0]["loss"]]),
              losses=[s["loss"] for s in ranks[0]["losses"]],
              reference_losses=[s["loss"] for s in ref["losses"]],
              assignment_cost_rel=[r["cost_rel"] for r in ranks],
              launches_per_step=timed[0]["launches_per_step"][-1],
              parity_launches_per_step=ranks[0]["launches_per_step"][-1],
              digests_equal=[len({r["digest"] for r in ranks}) == 1,
                             len({t["digest"] for t in timed}) == 1],
              reference_seconds=ref_seconds, ranks_seconds=ranks_seconds))
    if problems:
        raise AssertionError(f"train_ddp phase: {problems}")

    # the training CLI's own --multihost: NCCL, world 1 (and 2 on two
    # cards, one a rank)
    for world in (1, 2) if torch.cuda.device_count() >= 2 else (1,):
        t0 = time.perf_counter()
        spawn("nccl_job", world, tmp)
        res = [torch.load(f"{tmp}/nccl_{world}_{r}.pt", weights_only=False)
               for r in range(world)]
        cfg = train_config("r50-fast")
        keys = train_loss_keys(cfg)
        emit(dict(phase="train_ddp_nccl", world=world, cards=world,
                  backend=res[0]["backend"],
                  devices=[r["device"] for r in res],
                  iters=NCCL_ITERS, batch_per_rank=TRAIN_BS,
                  step_ms=[r["step_ms"] for r in res],
                  peak_bytes=[r["peak"] for r in res],
                  losses=[res[0]["losses"][i]["loss"]
                          for i in sorted(res[0]["losses"])],
                  launches_per_step=res[0]["launches_per_step"],
                  seconds=time.perf_counter() - t0,
                  device_count=torch.cuda.device_count()))
        want = want_train_launches(cfg)
        for r in res:
            if r["backend"] != "nccl" or r["world"] != world or \
                    not r["group_left"]:
                raise AssertionError(f"train_ddp_nccl: {r['backend']}, "
                                     f"world {r['world']}")
            if sorted(r["losses"]) != list(range(1, NCCL_ITERS + 1)) or any(
                    set(ld) != keys or not all(map(math.isfinite,
                                                   ld.values()))
                    for ld in r["losses"].values()):
                raise AssertionError("train_ddp_nccl: losses "
                                     f"{r['losses']}")
            if any(c != want for c in r["launches_per_step"]):
                raise AssertionError("train_ddp_nccl: launches "
                                     f"{r['launches_per_step']}")
        if world == 2 and res[0]["losses"] != res[1]["losses"]:
            raise AssertionError("train_ddp_nccl: the ranks' losses differ")
    return ranks


def phase_eval_dist(torch, tmp, ranks):
    """eval_dist: the two ranks' `distributed_streaming_eval` (run by the
    train_ddp processes) against this one process streaming the same two
    shards (explicit ranks): rank 0's metrics equal, every prediction
    bit for bit; 1/4/12/4/3/3 launches a frame on each rank."""
    import math

    import numpy as np

    from simpb_tpu_torch.training import evaluate

    cfg = flagship("bfloat16")
    model = evaluate.build_model(cfg, device="cuda", seed=0)
    dataset = ddp_eval_dataset(f"{tmp}/val/infos.pkl")
    t0 = time.perf_counter()
    for r in range(DDP_WORLD - 1, -1, -1):
        one = evaluate.distributed_streaming_eval(
            model, cfg, dataset, f"{tmp}/gather_one", world_size=DDP_WORLD,
            rank=r)
    seconds = time.perf_counter() - t0
    metrics, preds, tokens = one
    got = ranks[0]["eval"]
    same = lambda a, b: a == b or (math.isnan(a) and math.isnan(b))
    problems = []
    if ranks[1]["eval"]["metrics"] is not None:
        problems.append("rank 1 returned metrics")
    if list(got["metrics"]) != list(metrics) or not all(
            same(got["metrics"][k], metrics[k]) for k in metrics):
        problems.append("rank 0's metrics differ from one process's")
    if got["tokens"] != tokens or len(got["preds"]) != len(preds) or not \
            all(sorted(a) == sorted(b) and all(
                np.array_equal(a[k], b[k]) for k in a)
                for a, b in zip(got["preds"], preds)):
        problems.append("predictions differ from one process's")
    for r, res in enumerate(ranks):
        bad = [c for c in res["eval"]["launches_per_frame"]
               if c != WANT_LAUNCHES]
        if bad or not res["eval"]["launches_per_frame"]:
            problems.append(f"rank {r} launches {bad[:1]}")
    emit(dict(phase="eval_dist", config="simpb_r50_704x256_fast",
              trunk="bfloat16", head="bfloat16", world=DDP_WORLD,
              backend="gloo (set up by chip_smoke: two ranks on one card)",
              frames=len(tokens),
              frames_per_rank=[len(r["eval"]["launches_per_frame"])
                               for r in ranks],
              rank_seconds=[r["eval"]["seconds"] for r in ranks],
              one_process_seconds=seconds,
              launches_per_frame=ranks[0]["eval"]["launches_per_frame"][-1],
              metrics_equal=not problems,
              metrics={k: None if math.isnan(v) else v
                       for k, v in got["metrics"].items()}))
    if problems:
        raise AssertionError(f"eval_dist phase: {problems}")
    del model
    free_cuda(torch)


def phase_eval_multi(torch, tmp, device="cuda:0"):
    """eval_multi: `multidevice_streaming_eval(devices=["cuda:0"] * 4)`,
    the flagship as bench.py serves it, over MULTI_SCENES scenes of
    MULTI_SCENE_FRAMES frames (one shard a slot: bs 4 on one card),
    against `streaming_eval` of each shard alone at bs 1. The first
    decoder layer's outputs (before any temporal input or bank update)
    of every frame and slot within MULTI_TOL of their largest value; the
    decodes by instance ids (each frame's set of valid ids); launches
    1/4/12/4/3/3 a step, not a slot; ms a step and frames a second
    against the bs-1 streams in this call."""
    import numpy as np

    from simpb_tpu_torch.tools.test import eval_aug_conf
    from simpb_tpu_torch.training import evaluate
    from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

    cfg = flagship("bfloat16")
    model = evaluate.build_model(cfg, device=device, seed=0)
    n = MULTI_SCENES * MULTI_SCENE_FRAMES
    os.makedirs(f"{tmp}/multi")
    pkl = write_synthetic_infos(
        f"{tmp}/multi", n_frames=n, src_hw=SRC_HW,
        gap_at=tuple(range(MULTI_SCENE_FRAMES, n, MULTI_SCENE_FRAMES)))
    dataset = memory_datasets()(pkl, test_mode=True, sequences_split_num=1,
                                data_aug_conf=eval_aug_conf(cfg, *SRC_HW))
    layer0 = []
    hook = model.head.register_forward_hook(
        lambda mod, args, out: layer0.append(
            [out[k][0].float() for k in ("prediction", "classification")]))
    per_step, step_ms = [], []

    def timed(make):
        counted = counted_steps(per_step)(make)

        def steps(model, cfg):
            def clock(fn):
                def step(*args):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(*args)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    return out
                return step
            return tuple(clock(fn) for fn in counted(model, cfg))
        return steps

    try:
        reset_launch_counts()
        with rebound((evaluate, "make_stream_steps", timed)):
            t0 = time.perf_counter()
            multi = evaluate.multidevice_streaming_eval(
                model, cfg, dataset, devices=[device] * MULTI_SLOTS,
                tracking=True)
            multi_s = time.perf_counter() - t0
            multi_layer0, multi_ms = layer0[:], step_ms[:]
            singles, single_layer0, single_s = [], [], 0.0
            for s in range(MULTI_SLOTS):
                layer0.clear()
                t0 = time.perf_counter()
                singles.append(evaluate.streaming_eval(
                    model, cfg, dataset, world_size=MULTI_SLOTS, rank=s,
                    tracking=True))
                single_s += time.perf_counter() - t0
                single_layer0.append(layer0[:])
    finally:
        hook.remove()
    single_ms = step_ms[len(multi_ms):]
    worst, id_frames, id_equal = 0.0, 0, 0
    for s in range(MULTI_SLOTS):
        for t, (p1, c1) in enumerate(single_layer0[s]):
            p4, c4 = (x[s] for x in multi_layer0[t])
            for a, b in ((p4, p1[0]), (c4, c1[0])):
                worst = max(worst, float((a - b).abs().max())
                            / max(float(b.abs().max()), 1e-30))
    # the multi-slot predictions are shard-major: shard s's frames in order
    preds = multi[1]
    at = 0
    for s in range(MULTI_SLOTS):
        for p in singles[s][1]:
            id_frames += 1
            id_equal += int(np.array_equal(np.sort(p["track_ids"]),
                                           np.sort(preds[at]["track_ids"])))
            at += 1
    tokens_ok = multi[2] == [t for sg in singles for t in sg[2]]
    bad = [c for c in per_step[:len(multi_ms)] if c != WANT_LAUNCHES]
    # frames a second from the median step (the cold steps included in
    # the medians, one a stream)
    fps = MULTI_SLOTS / (statistics.median(multi_ms) / 1e3)
    fps1 = 1 / (statistics.median(single_ms) / 1e3)
    emit(dict(phase="eval_multi", config="simpb_r50_704x256_fast",
              trunk="bfloat16", head="bfloat16", slots=MULTI_SLOTS,
              devices=[device] * MULTI_SLOTS, batch=MULTI_SLOTS,
              steps=len(multi_ms), step_ms=multi_ms,
              step_ms_median=statistics.median(multi_ms),
              bs1_frame_ms_median=statistics.median(single_ms),
              frames_per_s_bs4=fps, frames_per_s_bs1=fps1,
              multi_seconds=multi_s, bs1_seconds=single_s,
              layer0_worst_share=worst, layer0_tol=MULTI_TOL,
              instance_id_frames_equal=[id_equal, id_frames],
              launches_per_step=per_step[len(multi_ms) - 1],
              tokens_shard_major=tokens_ok))
    problems = []
    if bad or len(multi_ms) != MULTI_SCENE_FRAMES:
        problems.append(f"launches {bad[:1]} over {len(multi_ms)} steps")
    if not worst <= MULTI_TOL:
        problems.append(f"layer-0 outputs {worst} of their largest value")
    if id_equal != id_frames or not tokens_ok:
        problems.append(f"instance ids equal in {id_equal}/{id_frames} "
                        f"frames, tokens shard-major {tokens_ok}")
    if problems:
        raise AssertionError(f"eval_multi phase: {problems}")
    del model
    free_cuda(torch)


def phase_ddp(torch):
    """train_ddp, eval_dist (in train_ddp's processes) and eval_multi,
    with their shared synthetic sets in one temporary directory; the
    kernels are built before any process starts."""
    import tempfile

    from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

    with tempfile.TemporaryDirectory() as tmp:
        train_pkl(tmp)
        os.makedirs(f"{tmp}/val")
        write_synthetic_infos(f"{tmp}/val", n_frames=EVAL_FRAMES,
                              gap_at=(EVAL_FRAMES // 2,), src_hw=SRC_HW)
        t0 = time.perf_counter()
        phase_eval_multi(torch, tmp)
        t1 = time.perf_counter()
        ranks = phase_train_ddp(torch, tmp)
        t2 = time.perf_counter()
        phase_eval_dist(torch, tmp, ranks)
        emit(dict(phase="ddp_seconds", eval_multi=t1 - t0,
                  train_ddp_and_nccl=t2 - t1,
                  eval_dist=time.perf_counter() - t2))


def main() -> int:
    import torch

    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from simpb_tpu_torch.ops import _kernels, conv_fused
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit(dict(phase="env", card=card, torch=torch.__version__,
              cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), tf32=False))

    t0 = time.perf_counter()
    libs = _kernels.build_all(SOURCES)
    ptxas = {}
    for name in SOURCES:
        log = _kernels.BUILD_DIR / f"{name}.ptxas.txt"
        ptxas[name] = ptxas_summary(log.read_text()) if log.exists() else []
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              libraries=[str(p.relative_to(_kernels.PKG_DIR.parent))
                         for p in libs],
              ptxas=ptxas))
    spills = [ln for ln in ptxas["sampling"] + ptxas["assignment"] + [
        ln for ln in ptxas["conv_fused"] if ln.startswith("maxpool")]
        if re.search(r"[1-9]\d* bytes spill", ln)]
    if spills:
        raise AssertionError(f"sampling or max-pool kernels spill: {spills}")

    summary, summary_r101, wrappers = phase_kernels(torch, conv_fused)
    probes = phase_probes(torch)
    phase_slice(torch, "float32", FP32_HEAD_FRAMES)
    # the main path: the flagship as bench.py serves it, bf16 head (run
    # second, so that the recorded calls sit in neither run's peak)
    calls = []
    launches = phase_slice(torch, "bfloat16", FRAMES, calls)
    sampling = phase_sampling(torch, calls, launches)
    del calls
    phase_parity(torch)
    phase_trunk(torch)
    r101_launches, r101_hybrid = phase_r101(torch)
    r101_launches = r101_launches["r101"]
    phase_trunk(torch, "r101", module=True)
    phase_eval(torch)
    phase_bench(torch)
    phase_profile(torch)
    phase_tools_bench(torch)
    phase_export(torch)
    encoder = phase_encoder2d(torch)
    exact = phase_exact(torch)  # exact MSDA, then the hybrid's H1-H3
    for row in exact:  # day 0's r101 demand pass
        if row["name"] in r101_hybrid:
            row["r101"] = r101_hybrid[row["name"]]
    train_launches, train_calls = phase_train(torch)
    train = phase_train_kernels(torch, train_calls, train_launches)
    del train_calls
    # the exact configs' training: the trainer's default, kernel D
    train_launches, train_calls = phase_train(torch, "r50", "train_exact")
    train.update(phase_train_kernels(torch, train_calls, train_launches,
                                     EXACT_TRAIN_KERNELS))
    del train_calls
    phase_train(torch, "r101-fast", "train_r101", R101_TRAIN_STEPS)
    # `--config r101`: exact MSDA, kernel D at the r101 column, on the
    # step's recorded calls
    train_launches, train_calls = phase_train(torch, "r101",
                                              "train_r101_exact", 1)
    d101 = phase_train_kernels(torch, train_calls, train_launches,
                               EXACT_TRAIN_KERNELS, synthetic=False)
    del train_calls
    train["msda_backward"]["r101"] = r101_entry(d101["msda_backward"])
    # the encoder's column: 14,960 queries a camera row
    train["msda_backward"]["encoder2d"] = encoder["msda_backward"]
    for row in exact:
        if row["name"] == "msda":
            row["encoder2d"] = encoder["msda"]
    phase_train_cli(torch)
    phase_train_cli_exact(torch)
    phase_ddp(torch)

    kernels = []
    for name, s in summary.items():
        r = summary_r101[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"simpb_tpu_torch/csrc/{TRUNK_SOURCE[name]}.cu",
            replaces=wrappers[name][2], launches=launches[name],
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            device_ms=s["device_ms"], plain_ms=s["plain_ms"],
            bound_ms=sum(s["bound"].values()),
            bound_by=max(s["bound"], key=s["bound"].get),
            library_ms=s["library_ms"],
            **({"cudnn_chain_ms": s["cudnn_chain_ms"]}
               if s["cudnn_chain_ms"] is not None else {}),
            # an r101 frame (simpb_r101_1408x512, the fused trunk)
            r101=dict(launches=r101_launches[name], ms=r["ms"],
                      device_ms=r["device_ms"], plain_ms=r["plain_ms"],
                      bound_ms=sum(r["bound"].values()),
                      bound_by=max(r["bound"], key=r["bound"].get),
                      library_ms=r["library_ms"],
                      cudnn_chain_ms=r["cudnn_chain_ms"]),
        ))
    kernels += (list(sampling.values()) + exact + list(train.values())
                + list(probes.values()))
    if len(kernels) != 22:
        raise AssertionError(f"{len(kernels)} kernels, want 22")
    emit(dict(phase="seconds", total=time.perf_counter() - start))
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
