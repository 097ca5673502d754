"""Conv + BatchNorm folding for inference, on the port's state dict
(port of `simpb_tpu/utils/fuse_bn.py`, reference tools/fuse_conv_bn.py).

The trunk's convs are bias-free, so the fold keeps the module structure:
each conv weight absorbs `scale / sqrt(var + eps)` per output channel,
and its BatchNorm becomes a bias add (scale 1, mean 0, var 1 - eps), in
JAX's arithmetic: a model loading the folded state serves the same
frames up to the fold's roundings.
"""
from __future__ import annotations

from typing import Dict

import torch

CONV_BN_PAIRS = (
    ("conv1", "bn1"),
    ("conv2", "bn2"),
    ("conv3", "bn3"),
    ("downsample_conv", "downsample_bn"),
)
BN_EPS = 1e-5


def _fold_pair(state: Dict[str, torch.Tensor], conv: str, bn: str,
               eps: float = BN_EPS) -> None:
    kernel = state[f"{conv}.weight"]  # [out, in, kh, kw]
    scale, bias = state[f"{bn}.weight"], state[f"{bn}.bias"]
    mean, var = state[f"{bn}.running_mean"], state[f"{bn}.running_var"]
    factor = (scale / torch.sqrt(var + eps)).to(kernel.dtype)
    state[f"{conv}.weight"] = kernel * factor[:, None, None, None]
    state[f"{bn}.weight"] = torch.ones_like(scale)
    state[f"{bn}.bias"] = (bias - mean * factor).to(bias.dtype)
    state[f"{bn}.running_mean"] = torch.zeros_like(mean)
    state[f"{bn}.running_var"] = torch.ones_like(var) * (1.0 - eps)


def fuse_backbone_bn(state: Dict[str, torch.Tensor],
                     prefix: str = "img_backbone.") -> Dict[str, torch.Tensor]:
    """A copy of the model state dict `state` with every BatchNorm of the
    trunk under `prefix` folded into its conv (numerically the same
    inference); the other entries are shared, not copied."""
    out = dict(state)
    with torch.no_grad():
        if f"{prefix}conv1.weight" in out and f"{prefix}bn1.weight" in out:
            _fold_pair(out, f"{prefix}conv1", f"{prefix}bn1")
        blocks = sorted({k[len(prefix):].split(".")[0] for k in out
                         if k.startswith(prefix + "layer")})
        for blk in blocks:
            for conv, bn in CONV_BN_PAIRS:
                c, b = f"{prefix}{blk}.{conv}", f"{prefix}{blk}.{bn}"
                if f"{c}.weight" in out and f"{b}.weight" in out:
                    _fold_pair(out, c, b)
    return out
