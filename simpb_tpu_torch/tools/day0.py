"""Day-0 serving decision for a reference checkpoint (port of the
repository's `tools/day0.py`).

Given a released torch `.pth` and a val pkl:

  1. **convert**: the `.pth` into the serving model
     (`utils/torch_convert.py::load_torch_checkpoint`);
  2. **measure**: a short guarded `streaming_eval` under the hybrid
     configuration with a correction capacity covering every (slot,
     level) entry (`--measure-capacity`): the `guard_msda_clamp_demand`
     maximum is the most entries of a camera whose samples leave their
     8x8 windows, the one number the choice turns on;
  3. **decide**: demand x `--capacity-margin`, rounded up to a multiple of
     32, at most `--hybrid-max-capacity` -> `<family>-hybrid` at that
     capacity (value-exact while the counters stay 0); else, or when the
     measurement itself overflowed, `<family>-guarded` (exact MSDA);
  4. **emit** `day0_decision.json` in `--out-dir` (the demand, the choice,
     its capacity, the serving command) and print it.

`--confirm-frames N` also streams N frames under the chosen
configuration and records its metrics and guard maxima.
`--finetune --train-ann-file train.pkl` runs the fast-semantics
fine-tune through the training CLI (`python -m
simpb_tpu_torch.tools.train --config r50-fast --load-from <pth>`) and
adds the `r50-fast-guarded` serving command for the tuned checkpoint.

Usage:
  python -m simpb_tpu_torch.tools.day0 --ann-file val.pkl \\
      --torch-checkpoint simpb_r50.pth [--config r50|tiny] \\
      [--demand-frames 50] [--out-dir work_dirs/day0] \\
      [--confirm-frames N] [--finetune --train-ann-file train.pkl] \\
      [--device cpu]

It runs on the card unless `--device cpu` is given. `--config r101` is
`simpb_r101_1408x512` (ResNet-101 at 1408x512, the fused trunk);
`--config tiny` runs only with `--device cpu` (its levels are smaller
than the hybrid's window, whose shrinking branch has no kernel).
The decision logic is the JAX tool's; no speed figure of the TPU is
carried into its rationale.
"""
import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys

# families whose hybrid runs only on the CPU: a level smaller than the
# 8x8 window takes the windowed lane's shrinking branch, which has no
# kernel on the card
CPU_ONLY_FAMILIES = {"tiny": "its pyramid (8x16 down to 1x2) is smaller "
                             "than the hybrid's 8x8 window (ROADMAP B.5)"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann-file", required=True, help="val pkl")
    p.add_argument("--torch-checkpoint", required=True)
    p.add_argument("--data-root", default="")
    p.add_argument("--config", default="r50", choices=["r50", "r101", "tiny"],
                   help="model family; the decision picks the serving "
                        "variant (hybrid or guarded) within it")
    p.add_argument("--src-h", type=int, default=900)
    p.add_argument("--src-w", type=int, default=1600)
    p.add_argument("--out-dir", default="work_dirs/day0")
    p.add_argument("--demand-frames", type=int, default=50,
                   help="frames in the demand-measurement pass")
    p.add_argument("--measure-capacity", type=int, default=None,
                   help="correction capacity during the measurement "
                        "(default: every (slot, level) entry, so that the "
                        "demand is measured with no overflow)")
    p.add_argument("--hybrid-max-capacity", type=int, default=512,
                   help="largest right-sized capacity still served as "
                        "hybrid; above it the correction lane approaches "
                        "exact resampling of every entry")
    p.add_argument("--capacity-margin", type=float, default=1.25,
                   help="headroom multiplier on the measured demand before "
                        "rounding up to a multiple of 32")
    p.add_argument("--confirm-frames", type=int, default=0,
                   help="also stream this many frames under the chosen "
                        "config (metrics and guard certificate)")
    p.add_argument("--finetune", action="store_true",
                   help="run the fast-semantics fine-tune through the "
                        "training CLI and emit the fast-guarded serving "
                        "command")
    p.add_argument("--train-ann-file", default=None,
                   help="train pkl for --finetune")
    p.add_argument("--finetune-steps", type=int, default=250)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def measurement_config(family: str, measure_capacity=None):
    """(config, entries a camera, capacity) of the demand pass: the
    family's base config with the hybrid's capacities and correction
    lane, the guards on and a capacity of every entry (or the given one),
    trunk bf16 (the fused trunk), head fp32."""
    from ..configs import base as cb

    base = {"r50": cb.simpb_r50_704x256, "r101": cb.simpb_r101_1408x512,
            "tiny": cb.simpb_tiny}[family]()
    hybrid = cb.simpb_r50_704x256_hybrid().head
    total = base.head.allocation_capacity * base.head.num_levels
    cap = measure_capacity or total
    head = dataclasses.replace(
        base.head, msda_gather_capacity=hybrid.msda_gather_capacity,
        msda_hybrid_mode=True, msda_clamp_capacity=cap,
        dfa_gather_capacity=hybrid.dfa_gather_capacity, guard_sampling=True)
    cfg = dataclasses.replace(base, head=head, compute_dtype="bfloat16",
                              backbone_fused_infer=True)
    return cfg, total, cap


def _serve_command(chosen, args):
    return (f"python -m simpb_tpu_torch.tools.test --config {chosen} "
            f"--torch-checkpoint {args.torch_checkpoint} "
            f"--ann-file {args.ann_file}")


def decide(demand: float, overflow: float, total_entries: int, args):
    """The serving choice from the demand pass's maxima (the JAX tool's
    rule): {chosen_config, msda_clamp_capacity, rationale,
    serve_command}."""
    if math.isnan(demand):
        raise SystemExit("demand counter missing from the eval metrics")
    sized = int(min(
        total_entries,
        32 * math.ceil(demand * args.capacity_margin / 32) or 32,
    ))
    if not math.isnan(overflow) and overflow > 0:
        # the measurement's own capacity was exceeded (only with a small
        # --measure-capacity): the demand is a lower bound
        sized = total_entries + 1
    if sized <= args.hybrid_max_capacity:
        chosen = f"{args.config}-hybrid"
        capacity = sized
        rationale = (
            f"demand max {demand:.0f} x margin {args.capacity_margin} "
            f"rounds to capacity {capacity} <= {args.hybrid_max_capacity}: "
            "the correction lane covers the clamped entries, value-exact "
            "serving while the counters stay 0")
    else:
        chosen = f"{args.config}-guarded"
        capacity = None
        rationale = (
            f"demand max {demand:.0f} needs capacity {sized} > "
            f"{args.hybrid_max_capacity}: the correction lane would "
            "approach exact resampling of every entry; serve the exact "
            "guarded config")
    return {"chosen_config": chosen, "msda_clamp_capacity": capacity,
            "rationale": rationale,
            "serve_command": _serve_command(chosen, args)}


def _rounded(metrics):
    return {k: (None if isinstance(v, float) and math.isnan(v)
                else round(float(v), 4)) for k, v in metrics.items()}


def main(argv=None):
    args = parse_args(argv)
    if args.config in CPU_ONLY_FAMILIES and args.device != "cpu":
        raise SystemExit(f"not served on the card: --config {args.config}: "
                         f"{CPU_ONLY_FAMILIES[args.config]}; give --device "
                         "cpu")
    from ..data.dataset import NuScenesDataset
    from ..training import evaluate as ev
    from ..utils.torch_convert import load_torch_checkpoint
    from .test import eval_aug_conf

    cfg, total_entries, measure_cap = measurement_config(
        args.config, args.measure_capacity)
    dataset = NuScenesDataset(
        args.ann_file, data_root=args.data_root, test_mode=True,
        data_aug_conf=eval_aug_conf(cfg, args.src_h, args.src_w),
        sequences_split_num=1)
    model = ev.build_model(cfg, device=args.device, seed=0)
    state = load_torch_checkpoint(args.torch_checkpoint, cfg, model)
    model.load_state_dict(state, strict=True)
    print(f"[day0] converted {args.torch_checkpoint}", flush=True)

    metrics, _, _ = ev.streaming_eval(model, cfg, dataset,
                                      max_frames=args.demand_frames,
                                      progress=True)
    demand = metrics.get("guard_msda_clamp_demand", float("nan"))
    overflow = metrics.get("guard_msda_clamp_overflow", float("nan"))
    dfa_overflow = metrics.get("guard_dfa_overflow", float("nan"))
    print(f"[day0] demand pass ({args.demand_frames} frames): "
          f"msda_clamp_demand max {demand:.0f} / {total_entries} entries a "
          f"camera; clamp_overflow {overflow:.0f}; dfa_overflow "
          f"{dfa_overflow:.0f}", flush=True)
    choice = decide(demand, overflow, total_entries, args)
    print(f"[day0] decision: {choice['chosen_config']} — "
          f"{choice['rationale']}", flush=True)
    decision = {
        "torch_checkpoint": args.torch_checkpoint,
        "demand_frames": args.demand_frames,
        "guard_msda_clamp_demand_max": demand,
        "guard_msda_clamp_overflow": overflow,
        "guard_dfa_overflow": dfa_overflow,
        "total_entries_per_camera": total_entries,
        **choice,
        "measurement_metrics": _rounded(metrics),
    }

    if args.finetune:
        if not args.train_ann_file:
            raise SystemExit("--finetune requires --train-ann-file")
        ft_dir = os.path.join(args.out_dir, "finetune")
        family = "tiny" if args.config == "tiny" else f"{args.config}-fast"
        cmd = [sys.executable, "-m", "simpb_tpu_torch.tools.train",
               "--ann-file", args.train_ann_file,
               "--data-root", args.data_root, "--config", family,
               "--load-from", args.torch_checkpoint,
               "--max-iters", str(args.finetune_steps),
               "--ckpt-interval", str(args.finetune_steps),
               "--work-dir", ft_dir,
               "--src-h", str(args.src_h), "--src-w", str(args.src_w)]
        if args.device:
            cmd += ["--device", args.device]
        print(f"[day0] fine-tune: {' '.join(cmd)}", flush=True)
        subprocess.run(cmd, check=True)
        tuned = os.path.join(ft_dir, f"ckpt_{args.finetune_steps}")
        decision["finetuned_checkpoint"] = tuned
        decision["finetuned_serve_command"] = (
            f"python -m simpb_tpu_torch.tools.test --config "
            f"{args.config}-fast-guarded --checkpoint {tuned} "
            f"--ann-file {args.ann_file}")
        print(f"[day0] fine-tuned checkpoint: {tuned} — serve with "
              f"{decision['finetuned_serve_command']}", flush=True)

    if args.confirm_frames:
        hybrid = choice["chosen_config"].endswith("hybrid")
        cfg_c = dataclasses.replace(cfg, head=dataclasses.replace(
            cfg.head, msda_hybrid_mode=hybrid,
            msda_clamp_capacity=choice["msda_clamp_capacity"] or measure_cap))
        model_c = ev.build_model(cfg_c, device=args.device, seed=0)
        model_c.load_state_dict(state, strict=True)
        confirm, _, _ = ev.streaming_eval(
            model_c, cfg_c, dataset, max_frames=args.confirm_frames,
            progress=True)
        decision["confirmation_metrics"] = _rounded(confirm)

    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "day0_decision.json")
    with open(out, "w") as f:
        json.dump(decision, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in decision.items()
                      if k != "measurement_metrics"}, indent=1))
    print(f"[day0] wrote {out}")
    return decision


if __name__ == "__main__":
    main()
