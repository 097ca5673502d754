"""Export a serving artifact: the streaming step as a `torch.export`
program with the weights in it (port of `tools/export.py`).

    python -m simpb_tpu_torch.tools.export --config r50-fast --out x.pt2
        [--checkpoint FILE | --torch-checkpoint F.pth] [--batch-size 1]
        [--fp32] [--fused-trunk] [--smoke] [--device cpu]

One call of the artifact is one streaming frame -> decoded detections
and the threaded temporal-state tuple (`utils/export.py`: the
signature, and `ServingModel`, which loads and runs it with
`simpb_tpu_torch.ops` and without the model code). The program runs on
the device it was exported on: the card unless `--device` names
another (JAX's `--platforms` / `--cpu`). Trunk and head bf16 unless
`--fp32` (the tiny config stays fp32, as in JAX); `--fused-trunk`
serves the fused trunk (K1-K4; under `stem_s2d` the module trunk, by
JAX's rule). `--checkpoint` reads a checkpoint of the port's trainer,
`--torch-checkpoint` a reference `.pth`; without either the weights are
random (seed 0). `--smoke` loads the bytes back and serves two frames
through the artifact and through the model, which must agree bit for
bit.
"""
import argparse
import dataclasses
import time

CONFIGS = {
    "r50": "simpb_r50_704x256",
    "r50-fast": "simpb_r50_704x256_fast",
    "r101": "simpb_r101_1408x512",
    "r101-fast": "simpb_r101_1408x512_fast",
    "tiny": "simpb_tiny",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="r50-fast", choices=list(CONFIGS))
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint of the port's trainer (ckpt_*)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference .pth to convert and embed")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--fp32", action="store_true",
                   help="keep fp32 compute (default bfloat16)")
    p.add_argument("--smoke", action="store_true",
                   help="load the bytes back and serve 2 frames against "
                        "the model")
    p.add_argument("--fused-trunk", action="store_true",
                   help="the fused inference trunk (K1-K4)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def build_config(args):
    from ..configs import base

    cfg = getattr(base, CONFIGS[args.config])()
    if not args.fp32 and args.config != "tiny":
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                                  head_dtype="bfloat16")
    if args.fused_trunk:
        cfg = dataclasses.replace(cfg, backbone_fused_infer=True)
    return cfg


def build_weights(args, cfg):
    """The serving model with the command line's weights."""
    from ..training.evaluate import build_model

    model = build_model(cfg, device=args.device, seed=0)
    if args.torch_checkpoint:
        from ..utils.torch_convert import load_torch_checkpoint

        model.load_state_dict(
            load_torch_checkpoint(args.torch_checkpoint, cfg, model),
            strict=True)
    elif args.checkpoint:
        from ..training.checkpoint import load_model_state

        trained = load_model_state(args.checkpoint)
        model.load_state_dict({k: trained[k] for k in model.state_dict()},
                              strict=True)
    else:
        print("WARNING: exporting RANDOM weights (no checkpoint given)",
              flush=True)
    return model


def smoke(served, model, cfg, bs):
    """Two frames (dt 5.0 s, then 0.5 s) through the artifact and through
    the model's step; returns (the artifact's last outputs, whether every
    output equals the model's bit for bit)."""
    import torch

    from ..utils.export import make_serving_fn
    from ..utils.synthetic import synthetic_rig

    hc = cfg.head
    w, h = cfg.input_size
    dev = served.device
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.randn((bs, hc.num_cams, h, w, 3), generator=gen, device=dev)
    proj = torch.from_numpy(synthetic_rig(bs, (w, h))).to(dev)
    t2c = torch.eye(4, device=dev).expand(bs, 4, 4).contiguous()
    step = make_serving_fn(cfg, model)
    ours = theirs = served.init_temporal(bs, hc.num_temp_instances,
                                         hc.num_anchor, hc.embed_dims)
    same = True
    with torch.inference_mode():
        for dt in (5.0, 0.5):
            dt = torch.full((bs,), dt, device=dev)
            out = served(img, proj, dt, t2c, ours)
            ref = step(img, proj, dt, t2c, theirs)
            same &= all(torch.equal(out[k], ref[k])
                        for k in out if k != "temporal")
            same &= all(torch.equal(a, b) for a, b in
                        zip(out["temporal"], ref["temporal"]))
            ours, theirs = out["temporal"], ref["temporal"]
    return out, same


def run(args):
    """The export of a parsed command line: writes `--out` and returns
    {"data": the artifact's bytes, "seconds": the export's, "cfg",
    "model", and with `--smoke` "served": the loaded artifact}."""
    import torch

    from ..utils.export import ServingModel, export_serving

    cfg = build_config(args)
    model = build_weights(args, cfg)
    t0 = time.perf_counter()
    data = export_serving(cfg, model, batch_size=args.batch_size)
    seconds = time.perf_counter() - t0
    with open(args.out, "wb") as f:
        f.write(data)
    dev = next(model.parameters()).device
    print(f"wrote {args.out}: {len(data) / 1e6:.1f} MB (device={dev}, "
          f"export {seconds:.1f} s)", flush=True)
    result = dict(data=data, seconds=seconds, cfg=cfg, model=model)
    if args.smoke:
        result["served"] = ServingModel.load(data)
        out, same = smoke(result["served"], model, cfg, args.batch_size)
        scores = out["scores"].float()
        if not torch.isfinite(scores).all() or not same:
            raise SystemExit(f"smoke FAILED: finite "
                             f"{bool(torch.isfinite(scores).all())}, equal "
                             f"to the model {same}")
        print(f"smoke OK: top score {float(scores.max()):.4f}, "
              f"{int(out['valid'].sum())} above threshold, bit-identical "
              "to the model", flush=True)
    return result


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
