"""Inference throughput benchmark CLI (port of `tools/benchmark.py`).

    python -m simpb_tpu_torch.tools.benchmark [--config r50|r50-fast|...]
        [--exact | --patch] [--dfa-cap N] [--msda-cap N] [--msda-sel N]
        [--msda-window H W] [--clamp-cap N] [--batch-size N] [--frames N]
        [--fp32] [--guard] [--no-remat] [--stem-s2d] [--device cpu]

JAX's flags over `utils/benchmark.py::run_benchmark` (a warm window,
then `--frames` frames of each of `--batch-size` streams timed, images
made on the device inside the window), printing JAX's JSON line (fps
and peak memory) and the device it ran on. The config is built as
JAX's tool builds it: the named config, trunk and head bf16 unless
`--fp32`, then the flags' overrides; `backbone_fused_infer` stays the
config's (off: the module trunk with K1, as JAX's tool serves it). It
runs on the card unless `--device` names another; a CPU run's fps is
the CPU's.

A flag that selects a setting the port refuses exits non-zero and names
it (`refused_flags`): `--msda-window` larger than a level of the
pyramid under `r50-hybrid` on the card (the hybrid's windowed lane has
no shrinking branch there, ROADMAP B.5). A shape a kernel's planner
refuses raises its ValueError (ROADMAP C.4).
"""
import argparse
import dataclasses
import json

CONFIGS = {
    "r50": "simpb_r50_704x256",
    "r50-fast": "simpb_r50_704x256_fast",
    "r50-guarded": "simpb_r50_704x256_guarded",
    "r50-fast-guarded": "simpb_r50_704x256_fast_guarded",
    "r50-hybrid": "simpb_r50_704x256_hybrid",
    "r101": "simpb_r101_1408x512",
    "r101-fast": "simpb_r101_1408x512_fast",
    "tiny": "simpb_tiny",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="r50-fast", choices=list(CONFIGS))
    p.add_argument("--clamp-cap", type=int, default=None,
                   help="override msda_clamp_capacity (the hybrid's "
                        "exact correction lane)")
    p.add_argument("--exact", action="store_true",
                   help="force exact MSDA sampling (windowed off)")
    p.add_argument("--patch", action="store_true",
                   help="force windowed (patch-mode) MSDA sampling")
    p.add_argument("--dfa-cap", type=int, default=None,
                   help="override dfa_gather_capacity (0 = uncapped)")
    p.add_argument("--msda-sel", type=int, default=None,
                   help="override msda_sel_levels (0 = all levels)")
    p.add_argument("--msda-cap", type=int, default=None,
                   help="override msda_gather_capacity (0 = uncapped)")
    p.add_argument("--msda-window", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="override msda_patch_hw (windowed-MSDA window)")
    p.add_argument("--batch-size", type=int, default=1,
                   help="concurrent temporal streams per card")
    p.add_argument("--frames", type=int, default=64,
                   help="frames per stream in the timed window")
    p.add_argument("--fp32", action="store_true",
                   help="the trunk and head in fp32 (default bf16)")
    p.add_argument("--guard", action="store_true",
                   help="force guard_sampling on (the guard counters, "
                        "charged against the number)")
    p.add_argument("--no-remat", action="store_true",
                   help="backbone_remat=False (a training lever; serving "
                        "does not read it)")
    p.add_argument("--stem-s2d", action="store_true",
                   help="the space-to-depth stem (the module trunk, by "
                        "JAX's rule)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def build_config(args):
    """The config of the command line, as JAX's tool builds it."""
    from ..configs import base

    cfg = getattr(base, CONFIGS[args.config])()
    if args.no_remat:
        cfg = dataclasses.replace(cfg, backbone_remat=False)
    if args.stem_s2d:
        cfg = dataclasses.replace(cfg, stem_s2d=True)
    if not args.fp32:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                                  head_dtype="bfloat16")
    head = cfg.head
    if args.exact:
        head = dataclasses.replace(head, msda_patch_mode=False)
    if args.patch:
        head = dataclasses.replace(head, msda_patch_mode=True)
    if args.dfa_cap is not None:
        head = dataclasses.replace(head,
                                   dfa_gather_capacity=args.dfa_cap or None)
    if args.msda_cap is not None:
        head = dataclasses.replace(
            head, msda_gather_capacity=args.msda_cap or None)
    if args.msda_sel is not None:
        head = dataclasses.replace(head, msda_sel_levels=args.msda_sel)
    if args.msda_window is not None:
        head = dataclasses.replace(head,
                                   msda_patch_hw=tuple(args.msda_window))
    if args.clamp_cap is not None:
        head = dataclasses.replace(head,
                                   msda_clamp_capacity=args.clamp_cap)
    if args.guard:
        head = dataclasses.replace(head, guard_sampling=True)
    return dataclasses.replace(cfg, head=head)


def pyramid(cfg):
    """The FPN's level shapes (H, W) at the config's input: strides 4 to
    32."""
    w, h = cfg.input_size
    return tuple((-(-h // s), -(-w // s)) for s in (4, 8, 16, 32))


def refused_flags(args, cfg, device):
    """The flags given that select a setting the port refuses on
    `device`."""
    refused = []
    ph, pw = cfg.head.msda_patch_hw
    if (args.msda_window is not None and cfg.head.msda_hybrid_mode
            and device.type == "cuda"
            and any(h < ph or w < pw for h, w in pyramid(cfg))):
        refused.append(f"--msda-window {ph} {pw} under --config "
                       f"{args.config} (a level smaller than the window: "
                       "the hybrid's shrinking branch, ROADMAP B.5)")
    return refused


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..models.detector import check_serving_config
    from ..utils.benchmark import run_benchmark
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = build_config(args)
    refused = refused_flags(args, cfg, device)
    if refused:
        raise SystemExit(f"not ported: {', '.join(refused)} (ROADMAP.md)")
    try:
        check_serving_config(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"--config {args.config}: {e}")
    fps, stats = run_benchmark(cfg, window=args.frames,
                               batch_size=args.batch_size,
                               return_stats=True, device=device)
    peak = stats["peak_hbm_bytes"]
    line = {
        "config": args.config,
        "msda_patch_mode": cfg.head.msda_patch_mode,
        "msda_hybrid_mode": cfg.head.msda_hybrid_mode,
        "msda_clamp_capacity": cfg.head.msda_clamp_capacity,
        "dfa_gather_capacity": cfg.head.dfa_gather_capacity,
        "msda_gather_capacity": cfg.head.msda_gather_capacity,
        "msda_sel_levels": cfg.head.msda_sel_levels,
        "msda_patch_hw": list(cfg.head.msda_patch_hw),
        "batch_size": args.batch_size,
        "six_cam_fps_per_chip": round(fps, 2),
        "peak_hbm_gib": (round(peak / 2**30, 3) if peak is not None
                         else None),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
