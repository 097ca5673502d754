"""Profiling harness: per-kernel device time of the streaming step, or of
the training step with --train (port of `tools/profile.py`).

    python -m simpb_tpu_torch.tools.profile [--train] [--out DIR]
        [--frames 4] [--top 25] [--device cpu]

Serving (the default) streams the config JAX's tool profiles,
`simpb_r50_704x256` with the trunk in bfloat16 (the module trunk with
K1, DFA and the exact MSDA kernel; head fp32) at bs 1: a cold frame and
a stream frame to warm up, then `--frames` stream frames under
`torch.profiler` (CPU and CUDA activity). `--train` profiles `--frames`
training steps of `tools/train.py --config r50` (trunk bf16, head fp32)
at bs 4 on `utils/synthetic.py`'s seeded batch, after one warm step.
JAX's tool parses `--train` and never reads it; this one does what its
docstring says.

It prints, as JAX's tool does, `total device time: X ms over N frames`
(the CUDA kernels' summed durations; memory copies and sets count too),
then the `--top` kernels by ms a frame with their launches a frame, then
the raw trace's path (a Chrome trace, `export_chrome_trace`, under
`--out`); and beside the total the profiled window's wall ms (host
clock from the first frame's start to a synchronize after the last):
the device's idle share is 1 - device / window. Last, one JSON line with
the same numbers and the launch counts of the port's kernel wrappers
over the window. `--device cpu` profiles CPU activity only and prints
`total cpu time` (each op's own time, summed).
"""
import argparse
import dataclasses
import json
import os
import re
import tempfile
import time
from collections import Counter

# the kernel each wrapper launches once a call (csrc/*.cu), for counting
# a trace's launches against the wrappers' counters
WRAPPER_KERNELS = {
    "maxpool_3x3_s2": "maxpool_3x3_s2_kernel",
    "bottleneck_down": "bottleneck_down_tc_kernel",
    "bottleneck": "bottleneck_tc_kernel",
    "conv3x3_bias": "conv3x3_tc_kernel",
    "deformable_aggregation": "dfa_kernel",
    "msda_patch_sel": "msda_sel_tc_kernel",
    "msda": "msda_kernel",
    "msda_patch_levels": "msda_levels_tc_kernel",
    "msda_hybrid_exact": "msda_hybrid_kernel",
    "clamp_select": "clamp_select_kernel",
    "clamp_demand": "clamp_demand_kernel",
    "deformable_aggregation_backward": "dfa_bwd_kernel",
    "msda_patch_sel_backward": "msda_sel_bwd_kernel",
    "msda_backward": "msda_bwd_kernel",
    "assignment": "lsa_warp_kernel",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "simpb_trace"))
    p.add_argument("--frames", type=int, default=4,
                   help="profiled stream frames (training steps)")
    p.add_argument("--train", action="store_true",
                   help="profile the training step")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def serve_config():
    """JAX's profiled config: `simpb_r50_704x256`, trunk bf16."""
    from ..configs.base import simpb_r50_704x256

    return dataclasses.replace(simpb_r50_704x256(), compute_dtype="bfloat16")


def train_config():
    """`tools/train.py --config r50`'s config."""
    from ..tools.train import build_config

    return build_config(argparse.Namespace(config="r50"))


def kernel_count(name: str, table: dict) -> int:
    """Launches in `table` ({event name: (us, launches)}) of the kernel
    named `name` (the symbol alone, not a longer name containing it)."""
    pat = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(name)}(?![A-Za-z0-9_])")
    return sum(n for k, (_, n) in table.items() if pat.search(k))


def _steps(args, dev):
    """(a function running one profiled frame or step, the config, the
    batch size), warmed up."""
    import torch

    bs = 4 if args.train else 1
    if args.train:
        from ..configs.base import TrainConfig
        from ..training.train_step import (build_train_model,
                                           build_train_step,
                                           create_train_state,
                                           init_temporal)
        from ..utils.synthetic import batch_to_torch, synthetic_train_batch

        cfg = train_config()
        tc = TrainConfig()
        model = build_train_model(cfg, device=dev, seed=0)
        state = create_train_state(model, tc)
        step = build_train_step(model, tc)
        batch = batch_to_torch(synthetic_train_batch(cfg, bs, seed=0), dev)
        carry = [state, *init_temporal(cfg, bs, device=dev)]

        def run():
            carry[:] = step(carry[0], batch, carry[1], carry[2], 0)[:3]

        run()  # warm
        return run, cfg, bs
    from ..training.evaluate import build_model, make_stream_steps
    from ..utils.synthetic import synthetic_rig

    cfg = serve_config()
    model = build_model(cfg, device=dev, seed=0)
    cold, stream = make_stream_steps(model, cfg)
    w, h = cfg.input_size
    gen = torch.Generator(device=dev).manual_seed(0)
    proj = torch.from_numpy(synthetic_rig(bs, (w, h))).to(dev)
    dt = torch.full((bs,), 0.5, device=dev)
    t2c = torch.eye(4, device=dev).expand(bs, 4, 4).contiguous()
    frame = lambda: torch.randn((bs, 6, h, w, 3), generator=gen, device=dev)
    _, state = cold(frame(), proj)
    box = [stream(frame(), proj, state, dt, t2c)[1]]  # warm

    def run():
        box[0] = stream(frame(), proj, box[0], dt, t2c)[1]

    return run, cfg, bs


def run(args):
    """Profile; print the tool's lines and return them as a dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..utils.device import resolve_device
    from ..ops import conv_fused, sampling
    from ..training import matching

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    step, cfg, bs = _steps(args, dev)
    sync()
    counters = (conv_fused, sampling, matching)
    for mod in counters:
        mod.reset_launch_counts()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            step()
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for mod in counters
                for k, v in mod.launch_counts().items() if v}

    table = {}  # event name -> [us, launches]
    if cuda:
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                t = table.setdefault(e.name, [0.0, 0])
                t[0] += e.time_range.elapsed_us()
                t[1] += 1
    else:
        for e in prof.key_averages():
            table[e.key] = [e.self_cpu_time_total, e.count]
    total_ms = sum(us for us, _ in table.values()) / 1e3
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.abspath(os.path.join(
        args.out, f"{'train' if args.train else 'serve'}_trace.json"))
    prof.export_chrome_trace(trace)

    what = "steps" if args.train else "frames"
    kind = "device" if cuda else "cpu"
    print(f"total {kind} time: {total_ms:.2f} ms over {args.frames} {what}")
    print(f"profiled window: {window_ms:.2f} ms over {args.frames} {what}"
          + (f", device idle share {1 - total_ms / window_ms:.4f}"
             if cuda else ""))
    top = Counter({k: us for k, (us, _) in table.items()})
    per = args.frames * 1e3
    for k, us in top.most_common(args.top):
        print(f"{us / per:9.3f} ms/{what[:-1]}  "
              f"{table[k][1] / args.frames:7.1f} launches/{what[:-1]}  "
              f"{k[:160]}")
    print(f"raw trace: {trace}")
    result = dict(
        tool="profile", mode="train" if args.train else "serve",
        config=("tools/train.py --config r50" if args.train
                else "simpb_r50_704x256 trunk bf16"),
        batch_size=bs, device=(torch.cuda.get_device_name(dev) if cuda
                               else "cpu"),
        frames=args.frames, window_ms=window_ms, **{f"total_{kind}_ms":
                                                    total_ms},
        idle_share=(1 - total_ms / window_ms) if cuda else None,
        wrapper_launches=launches,
        kernel_launches=({w: kernel_count(k, table)
                          for w, k in WRAPPER_KERNELS.items()
                          if kernel_count(k, table)} if cuda else {}),
        top=[[k[:160], table[k][0] / per, table[k][1] / args.frames]
             for k, _ in top.most_common(args.top)],
        trace=trace)
    print(json.dumps(result))
    return result


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
