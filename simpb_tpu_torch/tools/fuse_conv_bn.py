"""Fold the trunk's Conv+BN of a checkpoint for inference (port of
`tools/fuse_conv_bn.py`).

    python -m simpb_tpu_torch.tools.fuse_conv_bn --checkpoint work/ckpt_1000 \\
        --out work/ckpt_1000_fused

Reads a checkpoint of the port's trainer (`training/checkpoint.py`),
folds every BatchNorm of its model's trunk into the conv before it
(`utils/fuse_bn.py`) and writes the checkpoint with the folded model
state; everything else in it (optimizer moments, step, stream state) is
kept. The serving CLI's `--checkpoint` reads the result. Runs on the
CPU.
"""
import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint of the port's trainer (ckpt_*)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from ..training.checkpoint import FORMAT
    from ..utils.fuse_bn import fuse_backbone_bn

    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("format") != FORMAT:
        raise SystemExit(f"{args.checkpoint} is not a checkpoint of this "
                         f"package (format {FORMAT})")
    ckpt["model"] = fuse_backbone_bn(ckpt["model"])
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    torch.save(ckpt, tmp)
    os.replace(tmp, out)
    print(f"fused checkpoint written to {args.out}")


if __name__ == "__main__":
    main()
