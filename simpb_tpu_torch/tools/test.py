"""Evaluation CLI: streaming inference over the val set + nuScenes metrics
(port of the repository's `tools/test.py`).

Shards the val set at sequence boundaries, streams each frame through
the cold / stream step on the card, decodes, and scores with the native
mAP/NDS (`data/nuscenes_eval.py`) and, with `--tracking`, AMOTA
(`data/tracking_eval.py`) scorers.

Usage:
  python -m simpb_tpu_torch.tools.test \\
      --ann-file data/nuscenes/simpb_nuscenes_infos_val.pkl \\
      --config r50-fast --head-bf16 --checkpoint work_dirs/x/ckpt_best \\
      [--out results.json] [--tracking] [--device cpu]

The CLI serves every config as JAX's serves it under `--fused-trunk`
(the port's default, so the flag changes nothing): the fused inference
trunk (K1-K4), except under `stem_s2d` (`r101-fast`), where JAX's rule
(`models/detector.py::uses_fused_trunk`) takes the module trunk with the
space-to-depth stem. The configs are the JAX CLI's: `r50` (the default),
`r50-guarded` and `r101` (ResNet-101 at 1408x512) sample with exact
MSDA, `r50-fast`, `r50-fast-guarded`, `r101-fast` and `--msda-patch`
with the windowed one, and `r50-hybrid` with the windowed one and an
exact correction lane (`msda_hybrid`, capacity 256 entries a camera).
Under a guarded config the metrics
hold each `guard_*` counter's maximum over the frames, and a nonzero
one (a frame that left the exact semantics: for the hybrid,
`guard_msda_clamp_overflow`, a demand beyond the correction capacity)
makes the CLI exit 3 after printing them, as the JAX CLI does.
`--checkpoint` reads a checkpoint of the port's trainer
(`python -m simpb_tpu_torch.tools.train`, `training/checkpoint.py`):
the serving model takes the parameters and BatchNorm statistics it
holds. `--torch-checkpoint` reads a reference (mmdet-named) `.pth`.

Several processes, one card each (`torchrun --nproc-per-node N -m
simpb_tpu_torch.tools.test --multihost --gather-dir <shared dir> ...`,
or `--multihost --coordinator host:port --num-processes N --process-id
r` in each): each process streams one sequence shard
(`distributed_streaming_eval`), writes it to `--gather-dir`, and rank 0
scores the whole set, prints the metrics, writes `--out` and exits 3 on
a guard violation; the other ranks return after writing their shard.
One process with several cards and no `--device` streams one shard a
card as the slots of a batch (`multidevice_streaming_eval`).
`--show-dir DIR` renders each frame's detections above
`--show-threshold` on its images and a BEV panel and writes
`DIR/detections.mp4` (host-side OpenCV: without cv2 it raises, naming
it); it streams the one shard of a single stream, as JAX's CLI does.
Not ported (exit non-zero, naming the flag): `--cam-shards` > 1
(ROADMAP A.5).
"""
import argparse
import dataclasses
import json
import math
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann-file", required=True)
    p.add_argument("--data-root", default="")
    p.add_argument("--config", default="r50",
                   choices=["r50", "r50-fast", "r50-guarded",
                            "r50-fast-guarded", "r50-hybrid", "r101",
                            "r101-fast", "tiny"])
    p.add_argument("--src-h", type=int, default=900)
    p.add_argument("--src-w", type=int, default=1600)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint of the port's trainer (ckpt_*)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference (mmdet-named) torch .pth")
    p.add_argument("--out", default=None, help="submission json path")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--tracking", action="store_true")
    p.add_argument("--show-dir", default=None,
                   help="render the detections to DIR/detections.mp4 "
                        "(needs OpenCV)")
    p.add_argument("--show-threshold", type=float, default=0.3)
    p.add_argument("--cam-shards", type=int, default=1,
                   help="camera-axis sharding: only 1 is ported")
    p.add_argument("--msda-patch", action="store_true",
                   help="windowed (patch-mode) 2D cross-attn sampling")
    p.add_argument("--fused-trunk", action="store_true",
                   help="the fused inference trunk (the port's default; "
                        "stem_s2d configs take the module trunk)")
    p.add_argument("--draft-decode", action="store_true",
                   help="DCT-domain scaled JPEG decode (libjpeg n/8); "
                        "slightly different downscale filter chain, so "
                        "checkpoint-parity evals leave it off")
    p.add_argument("--head-bf16", action="store_true",
                   help="run the decoder head in bfloat16 like bench.py "
                        "(default keeps the head fp32, the reference's "
                        "fp32-head policy for checkpoint-parity evals)")
    p.add_argument("--gather-dir", default=None,
                   help="shared directory of the shards' parts "
                        "(multi-process eval)")
    p.add_argument("--multihost", action="store_true",
                   help="join a process group (torchrun's environment, "
                        "or --coordinator) and evaluate one sequence "
                        "shard a process")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 for --multihost")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def refused_flags(args):
    """The flags given that the port does not serve yet."""
    refused = []
    if args.cam_shards > 1:
        refused.append("--cam-shards > 1 (one stream's cameras over "
                       "several cards, ROADMAP A.5)")
    return refused


def _cards() -> int:
    import torch

    return torch.cuda.device_count()


def build_config(args):
    from ..configs.base import (
        simpb_r101_1408x512,
        simpb_r101_1408x512_fast,
        simpb_r50_704x256,
        simpb_r50_704x256_fast,
        simpb_r50_704x256_fast_guarded,
        simpb_r50_704x256_guarded,
        simpb_r50_704x256_hybrid,
        simpb_tiny,
    )

    cfg = {"r50": simpb_r50_704x256, "r50-fast": simpb_r50_704x256_fast,
           "r50-guarded": simpb_r50_704x256_guarded,
           "r50-fast-guarded": simpb_r50_704x256_fast_guarded,
           "r50-hybrid": simpb_r50_704x256_hybrid,
           "r101": simpb_r101_1408x512,
           "r101-fast": simpb_r101_1408x512_fast,
           "tiny": simpb_tiny}[args.config]()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                              backbone_fused_infer=True)
    if args.head_bf16:
        cfg = dataclasses.replace(cfg, head_dtype="bfloat16")
    if args.msda_patch:
        cfg = dataclasses.replace(
            cfg, head=dataclasses.replace(cfg.head, msda_patch_mode=True)
        )
    return cfg


def enforce_guards(metrics) -> int:
    """The exit code for sampling guard violations (0: none): a nonzero
    `guard_*` maximum means a frame's outputs left the exact semantics a
    guarded config promises; warns and returns 3."""
    from ..utils.guards import check_guard_violations

    violated = check_guard_violations(metrics)
    if not violated:
        return 0
    print("WARNING: sampling-exactness guard violated: "
          + ", ".join(f"{k}={float(metrics[k]):g}" for k in violated)
          + " — outputs deviated from exact semantics; raise the capacity "
          "caps or use the exact config", file=sys.stderr)
    return 3


def eval_aug_conf(cfg, src_h: int, src_w: int):
    """The test-mode augmentation config of the CLI: resize to cover the
    network input, crop the bottom rows."""
    fw, fh = cfg.input_size
    return {
        "resize_lim": (0.40, 0.47),
        "final_dim": (fh, fw),
        "bot_pct_lim": (0.0, 0.0),
        "rot_lim": (0, 0),
        "H": src_h,
        "W": src_w,
        "rand_flip": False,
        "rot3d_range": [0, 0],
    }


def main(argv=None):
    args = parse_args(argv)
    if args.cam_shards < 1:
        raise SystemExit(f"--cam-shards must be >= 1, got {args.cam_shards}")
    refused = refused_flags(args)
    if refused:
        raise SystemExit(f"not ported: {', '.join(refused)} (ROADMAP.md)")
    if not args.multihost:
        return evaluate(args)
    from ..parallel import mesh

    args.device = str(mesh.initialize_multihost(
        args.coordinator, args.num_processes, args.process_id,
        device=args.device))
    try:
        return evaluate(args)
    finally:
        mesh.shutdown()


def evaluate(args):
    """The eval of a parsed command line, in this process's world (the
    process group's, when one is initialised)."""
    from ..parallel.mesh import process_count

    cfg = build_config(args)

    from ..data.dataset import NuScenesDataset
    from ..data.postprocess import format_nuscenes_submission
    from ..models.detector import check_serving_config
    from ..training import evaluate as ev

    try:
        check_serving_config(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"--config {args.config}: {e}")
    dataset = NuScenesDataset(
        args.ann_file, data_root=args.data_root, test_mode=True,
        data_aug_conf=eval_aug_conf(cfg, args.src_h, args.src_w),
        sequences_split_num=1, draft_decode=args.draft_decode,
    )
    world = process_count()
    if world > 1 and not args.gather_dir:
        raise SystemExit("--gather-dir (a directory every process "
                         "shares) is required for multi-process eval")
    model = ev.build_model(cfg, device=args.device, seed=0)
    if args.checkpoint:
        from ..training.checkpoint import load_model_state

        trained = load_model_state(args.checkpoint)
        model.load_state_dict({k: trained[k] for k in model.state_dict()},
                              strict=True)
    if args.torch_checkpoint:
        from ..utils.torch_convert import load_torch_checkpoint

        model.load_state_dict(
            load_torch_checkpoint(args.torch_checkpoint, cfg, model),
            strict=True,
        )

    kw = dict(max_frames=args.max_frames, progress=True,
              tracking=args.tracking)
    if world > 1:
        result = ev.distributed_streaming_eval(model, cfg, dataset,
                                               args.gather_dir, **kw)
        if result is None:
            return None  # this rank's shard is written; rank 0 reports
        metrics, preds, tokens = result
    elif args.device is None and _cards() > 1 and not args.show_dir:
        metrics, preds, tokens = ev.multidevice_streaming_eval(
            model, cfg, dataset, **kw)
    else:  # one stream (a rendered eval is one stream, as in JAX)
        metrics, preds, tokens = ev.streaming_eval(
            model, cfg, dataset, show_dir=args.show_dir,
            show_threshold=args.show_threshold, **kw)
    # NaN marks classes absent from the eval split; emit null so the
    # output stays strict JSON
    print(json.dumps(
        {k: (None if math.isnan(v) else round(v, 4))
         for k, v in metrics.items()},
        indent=1,
    ))
    rc = enforce_guards(metrics)
    if rc:
        sys.exit(rc)

    if args.out:
        sub = format_nuscenes_submission(
            [
                {
                    "boxes_3d": p["boxes"],
                    "scores_3d": p["scores"],
                    "labels_3d": p["labels"],
                    **(
                        {"instance_ids": p["track_ids"]}
                        if "track_ids" in p
                        else {}
                    ),
                }
                for p in preds
            ],
            tokens,
            tracking=args.tracking,
        )
        with open(args.out, "w") as f:
            json.dump(sub, f)
        print(f"wrote {args.out}")
    return metrics


if __name__ == "__main__":
    main()
