"""ResNet trunk + FPN neck for inference (NHWC at the public functions).

Port of the serving trunk of `simpb_tpu/models/backbone.py`
(`fused_resnet_infer`, `fused_fpn_infer`). The modules hold the
parameters under the JAX tree's names (`img_backbone.layer1_0.conv1`,
`img_neck.fpn_0`, ...) as `nn.Conv2d` / `nn.BatchNorm2d`; inference
always runs the fused path:

* the 7x7/s2 stem is `F.conv2d`, its folded BN and ReLU plain torch;
* the stem max-pool, all 16 bottlenecks and the four FPN 3x3 convs go
  through the CUDA kernels of `ops/conv_fused.py` (their plain versions
  on the CPU);
* the FPN laterals (1x1 matmuls) and the nearest-upsample adds are plain
  torch.

BatchNorm is folded once per (device, dtype) and cached; loading a state
dict drops the cache. The module (unfused, trainable) trunk comes with
the training path.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv_fused import (
    bottleneck_down_fused_infer, bottleneck_fused_infer, conv3x3_bias_fused,
    fold_block_params, fold_bn, fold_downsample_params, maxpool_3x3_s2_fused,
)

RESNET_STAGE_BLOCKS = {
    26: (1, 1, 1, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


class Bottleneck(nn.Module):
    """Torch-style bottleneck parameters: 1x1 -> 3x3(stride) -> 1x1(4x)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = nn.Conv2d(
                inplanes, planes * 4, 1, stride, bias=False
            )
            self.downsample_bn = nn.BatchNorm2d(planes * 4)


class _FoldCache(nn.Module):
    """Caches derived inference tensors per (device, dtype); loading a
    state dict drops the cache."""

    def __init__(self):
        super().__init__()
        self._cache: Dict[tuple, object] = {}
        self._register_load_state_dict_pre_hook(self._drop_cache)

    def _drop_cache(self, *args, **kwargs):
        self._cache.clear()

    def _cached(self, device, dtype, build):
        key = (str(device), dtype)
        if key not in self._cache:
            with torch.no_grad():
                self._cache[key] = build()
        return self._cache[key]


class ResNet(_FoldCache):
    """ResNet-50/101 trunk returning C2..C5 maps (NHWC)."""

    def __init__(self, depth: int = 50):
        super().__init__()
        self.depth = depth
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.block_names: List[str] = []
        inplanes = 64
        for stage, num_blocks in enumerate(RESNET_STAGE_BLOCKS[depth]):
            planes = 64 * 2**stage
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, Bottleneck(
                    inplanes, planes, stride, downsample=(i == 0)
                ))
                self.block_names.append(name)
                inplanes = planes * 4

    def folded(self, device, dtype):
        """Stem kernel, stem BN fold and every block's folded weights,
        in the layouts and types the kernels take."""

        def build():
            stem_f, stem_b = fold_bn(self.bn1)
            blocks = []
            for name in self.block_names:
                blk = getattr(self, name)
                w1, b1, w2, b2, w3, b3 = fold_block_params(blk)
                folded = (w1.to(dtype), b1, w2.to(dtype), b2, w3.to(dtype),
                          b3)
                down = None
                if blk.has_downsample:
                    wd, bd = fold_downsample_params(blk)
                    down = (wd.to(dtype), bd)
                blocks.append((blk.stride, folded, down))
            return self.conv1.weight.to(dtype), stem_f, stem_b, blocks

        return self._cached(device, dtype, build)

    def forward(self, x: torch.Tensor, dtype=torch.float32):
        """x: [N, H, W, 3] -> four NHWC maps (strides 4, 8, 16, 32)."""
        stem_w, stem_f, stem_b, blocks = self.folded(x.device, dtype)
        x = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), stem_w, stride=2,
                     padding=3).permute(0, 2, 3, 1)
        x = torch.relu((x.float() * stem_f + stem_b).to(dtype)).contiguous()
        x = maxpool_3x3_s2_fused(x)
        outs = []
        idx = 0
        for num_blocks in RESNET_STAGE_BLOCKS[self.depth]:
            for i in range(num_blocks):
                stride, folded, down = blocks[idx]
                idx += 1
                if i == 0:
                    x = bottleneck_down_fused_infer(x, folded, down, stride)
                else:
                    x = bottleneck_fused_infer(x, folded)
            outs.append(x)
        return outs


def upsample2x_nearest(x: torch.Tensor, tgt_hw) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC map to `tgt_hw`."""
    n, h, w, c = x.shape
    if tuple(tgt_hw) == (2 * h, 2 * w):
        return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
            n, 2 * h, 2 * w, c
        )
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(tgt_hw),
                      mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


class FPN(_FoldCache):
    """mmdet-equivalent FPN for the released 4-in/4-out configuration:
    1x1 laterals, top-down nearest upsample adds, 3x3 output convs."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        self.num_levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(
                f"fpn_{i}", nn.Conv2d(out_channels, out_channels, 3, padding=1)
            )

    def folded(self, device, dtype):
        def build():
            lat, out = [], []
            for i in range(self.num_levels):
                la = getattr(self, f"lateral_{i}")
                lat.append((la.weight[:, :, 0, 0].t().to(dtype),
                            la.bias.to(dtype)))
                fp = getattr(self, f"fpn_{i}")
                out.append((fp.weight.permute(2, 3, 1, 0).to(dtype),
                            fp.bias.float()))
            return lat, out

        return self._cached(device, dtype, build)

    def forward(self, inputs: Sequence[torch.Tensor], dtype=torch.float32):
        lat_w, out_w = self.folded(inputs[0].device, dtype)
        laterals = [
            torch.matmul(x.to(dtype), w) + b
            for x, (w, b) in zip(inputs, lat_w)
        ]
        for i in range(len(laterals) - 1, 0, -1):
            up = upsample2x_nearest(laterals[i], laterals[i - 1].shape[1:3])
            laterals[i - 1] = laterals[i - 1] + up
        return [
            conv3x3_bias_fused(lat.contiguous(), w, b)
            for lat, (w, b) in zip(laterals, out_w)
        ]
