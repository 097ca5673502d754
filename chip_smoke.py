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
             version at every full-width shape of the main path, at the
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
11. exact  — the exact-sampling serving path. (a) Frames: the configs
             the bench serves under SIMPB_EXACT (`simpb_r50_704x256`:
             exact MSDA, no slot capacity, DFA capacity 4096),
             SIMPB_GUARDED (`_guarded`: exact MSDA, capacities 208 and
             2304, guard counters) and SIMPB_FAST_GUARDED
             (`_fast_guarded`: the flagship and its counters, windowed
             ones among them), trunk and head bf16: a cold frame and
             FRAMES stream frames each, the launch counts set to 0 just
             before and read just after; 1/4/12/4/3 trunk and DFA
             launches a frame, and 3 of exact MSDA (0 of MSDA-sel), or
             the reverse for `_fast_guarded`; finite, sorted decodes;
             frame ms, and each guard counter's maximum. The last
             frame's sampling calls are recorded. (b) Kernels: the exact
             MSDA kernel against `msda_plain` within EXACT_TOL, and DFA
             at capacities 4096 and 2304 against its plain version, on
             the recorded calls and on synthetic full-width cases in fp32
             and bf16 (Q 256 and 208, locations at and past every
             border, all-zero locations, 207 queries, the tiny widths),
             each launched twice (bit-identical), timed as in phase 6,
             exact MSDA beside the grid_sample chain (mmcv's plain
             formulation, one `F.grid_sample` a level and the weighted
             sum; timed, and held to `msda_plain` in fp32 once). (c) The
             eval CLI: `tools/test.py --config r50-guarded --tracking`
             through its `main` over a synthetic 1600x900 pkl of
             EXACT_CLI_FRAMES frames (decoded frames served from memory),
             launches counted; it prints the guard maxima and must exit 3
             exactly when one is nonzero.
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
             (bit-identical: no atomics), D1 and D2 (and D2 over each
             level's tiles alone) timed apart on the device, beside the
             grid_sample chain's backward (timed only).
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

Then the kernels' summary line, the card line, and as the last line
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
# the exact phase's configs: the bench's switches, in bench.py's order
EXACT_SWITCHES = ("SIMPB_EXACT", "SIMPB_GUARDED", "SIMPB_FAST_GUARDED")
EXACT_CLI_FRAMES = 6  # the eval CLI's frames under r50-guarded
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

# ResNet-50 stages at 704x256: (mid channels, out channels, output H, W,
# stride of the stage head, blocks)
STAGES = ((64, 256, 64, 176, 1, 3), (128, 512, 32, 88, 2, 4),
          (256, 1024, 16, 44, 2, 6), (512, 2048, 8, 22, 2, 3))


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


def kernel_cases():
    """(name, calls per frame, shapes) for every distinct full-width
    call of the main path, an odd-sized max-pool, one whose channels
    take no 16-byte packs, and the tiny config's smallest maps (no call
    a frame)."""
    cases = [("maxpool_3x3_s2", 1, dict(x=(6, 128, 352, 64))),
             ("maxpool_3x3_s2", 0, dict(x=(6, 127, 351, 64))),
             ("maxpool_3x3_s2", 0, dict(x=(2, 33, 47, 30)))]
    cin = 64
    for cm, co, h, w, s, n in STAGES:
        hin, win = h * s, w * s
        cases.append(("bottleneck_down", 1, dict(
            x=(6, hin, win, cin), c=cin, cm=cm, co=co, stride=s)))
        cases.append(("bottleneck", n - 1, dict(
            x=(6, h, w, co), c=co, cm=cm, co=co, stride=1)))
        cases.append(("conv3x3_bias", 1, dict(x=(6, h, w, 256), c=256,
                                              co=256)))
        cin = co
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    wrappers = {n: (w, p, tpu) for n, w, p, tpu in conv_fused.KERNELS}
    # per kernel, over a frame's calls at bf16 (the main path's type);
    # `bound` sums each call's bound by what bounds that call
    summary = {n: dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
                       library_ms=0.0, cudnn_chain_ms=0.0,
                       bound={"bytes": 0.0, "operations": 0.0})
               for n in wrappers}
    for case in kernel_cases():
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
                      shape=list(a["x"]), per_frame=count,
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
            s = summary[name]
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
    return summary, wrappers


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
    `calls`, then run the wrapper itself."""
    from simpb_tpu_torch.models import dfa, group_attn
    from simpb_tpu_torch.ops import sampling

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
        (group_attn, "msda", recorder("msda")))


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
    elif name == "msda_patch_sel" and dname == "bfloat16":
        o_ms = 3 * ops / PEAK_OPS["bfloat16"] * 1e3
    else:
        o_ms = ops / PEAK_OPS["float32"] * 1e3
    b_ms = byts / PEAK_BYTES * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def within(got, ref, tol):
    """(ok, max abs errors): each output within `tol` of max(|plain|,
    1)."""
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    return all(e <= tol * max(r.abs().max().item(), 1.0)
               for e, r in zip(errs, ref)), errs


def hold_case(torch, label, name, wrapper, plain, args, kwargs, tol, work,
              library=None):
    """One sampling call through its kernel against its plain version:
    one launch (the count rises by one), a second launch with the same
    bits, every output within `tol` of max(|plain|, 1). Timed through the
    wrapper back to back (`ms`), on the device alone (`device_ms`), the
    plain version and `library` (a PyTorch call of the same function,
    timed only); `work` is (bytes, operations). Emits the case's line and
    returns it; raises on a failure."""
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
    ok, errs = within(got, ref, tol)
    ok = ok and launched == 1 and same
    dname = str(args[0].dtype).split(".")[-1]
    bound, bound_by = sampling_bound(name, dname, *work)
    line = dict(phase="sampling", case=label, name=name, dtype=dname,
                max_abs_err=errs, tol_share=tol, ok=ok, launches=launched,
                deterministic=same,
                ms=cuda_ms(lambda: wrapper(*args, **kwargs)),
                device_ms=device_ms(lambda: wrapper(*args, **kwargs)),
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


def exact_config(switch):
    """The config `python -m simpb_tpu_torch.bench` serves under the
    environment switch `switch` (trunk and head bf16, the fused trunk)."""
    from simpb_tpu_torch import bench

    saved = os.environ.get(switch)
    os.environ[switch] = "1"
    try:
        return bench.config_name(), bench.config()
    finally:
        if saved is None:
            del os.environ[switch]
        else:
            os.environ[switch] = saved


def exact_launches(cfg):
    """Launches a frame of a served config: the trunk's and DFA's as the
    flagship's, then exact MSDA or MSDA-sel for the 2D cross-attention."""
    want = {k: v for k, v in WANT_LAUNCHES.items() if k != "msda_patch_sel"}
    want["msda_patch_sel" if cfg.head.msda_patch_mode else "msda"] = 3
    return want


def phase_exact_frames(torch):
    """The three configs of EXACT_SWITCHES as the bench serves them: cold
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
                  for i, (n, args, kw) in enumerate(rec)]
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
    return kernel_row("msda", kernels["msda"][2], launches[main]["msda"],
                      summary["msda"])


def phase_exact_cli(torch):
    """`python -m simpb_tpu_torch.tools.test --config r50-guarded` through
    its `main` over a synthetic 1600x900 infos pkl of EXACT_CLI_FRAMES
    frames (decoded frames served from memory by a dataset subclass: no
    Pillow on the card's machine), the launch counts set to 0 just before
    and read just after. The CLI prints the metrics with the guard
    maxima; it must exit 3 exactly when one is nonzero."""
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
                test_cli.main(["--ann-file", pkl, "--config", "r50-guarded",
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
        exact_config("SIMPB_GUARDED")[1]).items()}
    emit(dict(phase="exact_cli", argv="--config r50-guarded --tracking",
              frames=EXACT_CLI_FRAMES, source_hw=[src_h, src_w],
              seconds=seconds, exit_code=code, guard_maxima=guards,
              violated=violated, launches=launches,
              metrics={k: metrics[k] for k in ("mAP", "NDS", "AMOTA")}))
    if sorted(guards) != ["guard_dfa_overflow", "guard_msda_overflow"]:
        raise AssertionError(f"exact_cli: guard maxima {guards}")
    if code != (3 if violated else 0):
        raise AssertionError(f"exact_cli: exit {code}, violations "
                             f"{violated}")
    if launches != want:
        raise AssertionError(f"exact_cli: launches {launches}, want {want}")
    free_cuda(torch)


def phase_exact(torch):
    """The exact-sampling serving path (see the module docstring); returns
    the exact MSDA kernel's entry of the kernels line."""
    launches, calls = phase_exact_frames(torch)
    row = phase_exact_kernels(torch, calls, launches)
    del calls
    free_cuda(torch)
    phase_exact_cli(torch)
    return row


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


def phase_trunk(torch):
    """ResNet-50 + FPN at the main path's input in bf16 through the
    kernels and through their plain versions, each against the fp32
    plain trunk: per FPN level the kernels' relative L2 error may be at
    most TRUNK_RATIO times the plain route's plus TRUNK_FLOOR. The
    kernel phase's checks use random activations; this one the trunk's
    own."""
    import dataclasses

    from simpb_tpu_torch.configs.base import simpb_r50_704x256_fast
    from simpb_tpu_torch.training.evaluate import build_model

    cfg = dataclasses.replace(simpb_r50_704x256_fast(),
                              backbone_fused_infer=True)
    model = build_model(cfg, device="cuda", seed=0)
    w, h = cfg.input_size
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(6, h, w, 3, generator=gen, device="cuda")

    def trunk(dtype):
        with torch.inference_mode():
            return [f.float() for f in model.img_neck(
                model.img_backbone(x, dtype), dtype)]

    with plain_route():
        ref = trunk(torch.float32)
        plain = trunk(torch.bfloat16)
    kern = trunk(torch.bfloat16)
    # the stem as the trunk runs it (fp32 sum of the bf16-rounded image
    # and kernel into the BN) and, timed only, the bf16 conv it replaced
    net = model.img_backbone
    stem_w, stem_f, stem_b, _ = net.folded(x.device, torch.bfloat16)
    w16 = stem_w.bfloat16()
    xc = x.bfloat16().permute(0, 3, 1, 2)

    def bf16_conv_stem():
        y = torch.nn.functional.conv2d(xc, w16, stride=2, padding=3)
        return torch.relu((y.permute(0, 2, 3, 1).float() * stem_f + stem_b)
                          .bfloat16())

    with torch.inference_mode():
        stem_ms = cuda_ms(lambda: net.stem(x, torch.bfloat16))
        bf16_stem_ms = cuda_ms(bf16_conv_stem)
    rel = lambda a, r: ((a - r).norm() / r.norm()).item()
    levels = []
    for lvl, (k, p, r) in enumerate(zip(kern, plain, ref)):
        ek, ep = rel(k, r), rel(p, r)
        ok = bool(torch.isfinite(k).all()) and k.shape == r.shape and \
            ek <= TRUNK_RATIO * ep + TRUNK_FLOOR
        levels.append(dict(level=lvl, shape=list(k.shape), kernels=ek,
                           plain_bf16=ep, ok=ok))
    emit(dict(phase="trunk", config="simpb_r50_704x256_fast",
              dtype="bfloat16", ratio=TRUNK_RATIO, floor=TRUNK_FLOOR,
              rel_l2_vs_fp32_plain=levels, stem_ms=stem_ms,
              bf16_conv_stem_ms=bf16_stem_ms))
    bad = [lv for lv in levels if not lv["ok"]]
    if bad:
        raise AssertionError(f"bf16 trunk check failed: {bad}")
    del model
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


def phase_bench(torch):
    """The port's bench with a short window; prints its JSON line."""
    from simpb_tpu_torch import bench
    from simpb_tpu_torch.utils.benchmark import run_benchmark

    cfg = bench.config()
    reset_launch_counts()
    fps, stats = run_benchmark(cfg, window=BENCH_WINDOW, batch_size=1,
                               return_stats=True)
    launches = launch_counts()
    free_cuda(torch)
    emit(bench.result(fps, stats))
    want = {k: 2 * BENCH_WINDOW * n for k, n in WANT_LAUNCHES.items()}
    got = {k: n for k, n in launches.items() if n}
    emit(dict(phase="bench", config="simpb_r50_704x256_fast",
              trunk=cfg.compute_dtype, head=cfg.head_dtype,
              window=BENCH_WINDOW, fps=fps,
              peak_hbm_bytes=stats["peak_hbm_bytes"], launches=got))
    if not fps > 0 or not stats["peak_hbm_bytes"]:
        raise AssertionError(f"bench: fps {fps}, stats {stats}")
    if got != want:
        raise AssertionError(f"bench: launches {got}, want {want}")


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
                 "r50": "simpb_r50_704x256"}


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


def phase_train(torch, config="r50-fast", phase="train"):
    """The training step of `tools/train.py --config <config>` at full
    width: bs 4 x 6 cameras, one warm step, then TRAIN_STEPS steps
    carrying the temporal and DN state, the launch counts set to 0 just
    before and read just after. Returns (launches, recorded calls of the
    last step)."""
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
    for i in range(TRAIN_STEPS):
        last = i == TRAIN_STEPS - 1
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
              backbone_remat=cfg.backbone_remat,
              grid_mask=cfg.use_grid_mask, drop_out=cfg.head.drop_out,
              steps=TRAIN_STEPS, warm_step_ms=warm_ms, step_ms=times,
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
    D2 over all tiles, and D2 over each level's tiles alone (`D2_<h>x<w>`;
    the small levels' few tiles see as many records as the large ones'
    many), each queued alone on one set of buffers (D2 reads the records
    that D1 left)."""
    value, ss, loc, attw, gs, gw = args
    b, _, c = value.shape
    q, heads, _, points = loc.shape[1:5]
    plan = sampling.plan_msda_backward(b, q, heads, points, c, ss.shapes)
    bufs = sampling._msda_bwd_buffers(value, loc, attw, plan)
    gs, gw = gs.float().contiguous(), gw.float().contiguous()
    launch = lambda stages, tiles=None: sampling._msda_bwd_launch(
        value, loc, attw, gs, gw, plan, bufs, stages, tiles)
    launch(3)
    parts = {"D1": device_ms(lambda: launch(1), iters=3),
             "D2": device_ms(lambda: launch(2), iters=3)}
    for lvl, (h, w) in enumerate(ss.shapes):
        lo = plan.first[lvl]
        tiles = (lo, lo + -(-h // sampling.B2_TILE) * -(-w // sampling.B2_TILE))
        parts[f"D2_{h}x{w}"] = device_ms(lambda: launch(2, tiles), iters=3)
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
        "msda_backward")):
    """(label, name, args) of the gradient checks of the backward kernels
    `names`: their recorded calls of the last step, then synthetic
    full-width cases in fp32 and bf16 (B and C: phase 6's inputs with a
    random output gradient; D: the exact phase's with random sampled and
    wsum gradients)."""
    cases = [(f"step_call_{i}", name, args + tuple(
        kwargs.get(k) for k in ("gather_capacity", "thresholds")
        if name == "deformable_aggregation_backward" and k in kwargs))
        for i, (name, args, kwargs) in enumerate(calls) if name in names]
    for dtype in (torch.float32, torch.bfloat16):
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
                        names=FAST_TRAIN_KERNELS):
    """The kernels `names` against their plain versions. The backwards
    (B, C, D) on the last step's recorded calls and on synthetic cases,
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
                                        backwards):
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


def main() -> int:
    import torch

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

    summary, wrappers = phase_kernels(torch, conv_fused)
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
    phase_eval(torch)
    phase_bench(torch)
    exact = phase_exact(torch)
    train_launches, train_calls = phase_train(torch)
    train = phase_train_kernels(torch, train_calls, train_launches)
    del train_calls
    # the exact configs' training: the trainer's default, kernel D
    train_launches, train_calls = phase_train(torch, "r50", "train_exact")
    train.update(phase_train_kernels(torch, train_calls, train_launches,
                                     EXACT_TRAIN_KERNELS))
    del train_calls
    phase_train_cli(torch)
    phase_train_cli_exact(torch)

    kernels = []
    for name, s in summary.items():
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
        ))
    kernels += (list(sampling.values()) + [exact] + list(train.values())
                + list(probes.values()))
    if len(kernels) != 18:
        raise AssertionError(f"{len(kernels)} kernels, want 18")
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
