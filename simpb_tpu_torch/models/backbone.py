"""ResNet trunk + FPN neck (NHWC at the public functions).

Port of `simpb_tpu/models/backbone.py`. The modules hold the parameters
under the JAX tree's names (`img_backbone.layer1_0.conv1`,
`img_neck.fpn_0`, ...) as `nn.Conv2d` / `nn.BatchNorm2d`. Three trunks
compute over them; `models/detector.py` picks one by JAX's rule.

The fused inference trunk (`forward`; `fused_resnet_infer`,
`fused_fpn_infer` in JAX, taken when `backbone_fused_infer` is set and
`stem_s2d` is not):

* the 7x7/s2 stem is `F.conv2d`, its folded BN and ReLU plain torch.
  In bf16 the conv's operands are rounded to bf16 but its sum stays in
  fp32 (TF32 off) and goes into the folded BN unrounded; only the BN's
  result rounds to bf16, then the ReLU. That is what JAX computes: the
  JAX source rounds the conv to bf16 first, but XLA's excess precision
  (on by default) drops that rounding;
* the stem max-pool, all 16 or 33 bottlenecks and the four FPN 3x3
  convs go through the CUDA kernels of `ops/conv_fused.py` (their plain
  versions on the CPU);
* the FPN laterals (1x1 matmuls) and the nearest-upsample adds are plain
  torch. BatchNorm is folded once per (device, dtype) and cached;
  loading a state dict drops the cache.

The module trunk at inference (`forward_module`; JAX's
`ResNet.__call__(train=False)`, then the module FPN): the stem
(`stem_conv`: the 7x7/s2 conv, or with `stem_s2d` and even H and W the
space-to-depth conv of `StemConv`), every conv on `F.conv2d` in the
compute dtype, BatchNorm unfolded on the running statistics in flax's
arithmetic (`batch_norm_infer`), the stem max-pool on kernel K1 (JAX's
`maxpool_3x3_s2` has its values), and the module FPN
(`FPN.forward_train`). Each conv's output rounds to the compute dtype
before its BatchNorm, as the JAX source says; XLA on the CPU drops that
rounding too (tests/test_torch_port_r101.py shows it on one bottleneck
bit for bit), so the bf16 module trunk agrees with JAX's on the CPU to
bf16 roundings, not bit for bit.

Training (`forward_train`) runs the module trunk, as the JAX train path
does (it never runs the fused kernels): plain convs in the compute
dtype, BatchNorm on the batch statistics (`batch_norm_train`, flax's
arithmetic: fp32 statistics, the biased variance E[x^2] - E[x]^2, and
the running averages at momentum 0.9), `F.max_pool2d` for the stem pool
(its backward routes a tied window's gradient to one element, as
`nn.max_pool`'s does), each bottleneck optionally rematerialised with
`torch.utils.checkpoint` (the statistics of the first forward update
the running averages once; the recompute's are dropped, as `nn.remat`
drops the recomputed mutation), and the module FPN. Under a process
group the batch statistics are the global batch's (a SyncBatchNorm);
the recompute runs the statistics' all-reduce again inside the
backward, in the graph's order, which is the same on every rank.
`DenseDepthNet` is the training-only depth head.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint as checkpoint

from ..ops.conv_fused import (
    bottleneck_down_fused_infer, bottleneck_fused_infer, conv3x3_bias_fused,
    fold_block_params, fold_bn, fold_downsample_params, maxpool_3x3_s2_fused,
)
from ..parallel.mesh import all_reduce_sum, is_initialized
from .layers import cast

RESNET_STAGE_BLOCKS = {
    26: (1, 1, 1, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


@contextlib.contextmanager
def _ieee_fp32_conv():
    """cuDNN's fp32 convolutions in full fp32 (no TF32) inside."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def _bn_affine(xf, mean, var, bn: nn.BatchNorm2d, dtype):
    """flax's normalisation of an NCHW map `xf` (fp32 or wider):
    `(x - mean) * (rsqrt(var + eps) * scale) + bias`, then `dtype`."""
    mul = torch.rsqrt(var + BN_EPS) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None,
                                                                 None]
    return cast(y, dtype)


def batch_norm_infer(x: torch.Tensor, bn: nn.BatchNorm2d, dtype):
    """flax `nn.BatchNorm(use_running_average=True, dtype=dtype)` on an
    NCHW map: the running statistics in fp32, x promoted to fp32 (or
    wider), the result in `dtype`."""
    xf = cast(x, torch.promote_types(x.dtype, torch.float32))
    return _bn_affine(xf, cast(bn.running_mean, xf.dtype),
                      cast(bn.running_var, xf.dtype), bn, dtype)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d, dtype):
    """flax `nn.BatchNorm(use_running_average=False)` on an NCHW map:
    batch statistics in fp32 or wider (mean and the biased E[x^2] -
    E[x]^2, floored at 0), `(x - mean) * (rsqrt(var + eps) * scale) +
    bias` in that type, returned in `dtype` with the (mean, var) of the
    batch (detached).

    Under a process group the statistics are the global batch's, as
    JAX's BatchNorm takes them over the whole array under `pjit`: the
    ranks' sums of x, of x^2 and their element counts are all-reduced
    (differentiably: their gradients are summed over the ranks too), so
    every rank normalises alike and keeps equal running statistics."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if is_initialized():
        c = xf.shape[1]
        sums = all_reduce_sum(torch.cat([
            xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
            torch.full((1,), xf.numel() // c, dtype=xf.dtype,
                       device=xf.device)]))
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
    else:
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
    return _bn_affine(xf, mean, var, bn, dtype), (mean.detach(),
                                                  var.detach())


def update_running_stats(bn: nn.BatchNorm2d, stats) -> None:
    """flax's running averages: m * ra + (1 - m) * batch statistic."""
    mean, var = stats
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                              + (1 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                             + (1 - BN_MOMENTUM) * var)


def _conv(mod: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    b = cast(mod.bias, dtype) if mod.bias is not None else None
    return F.conv2d(cast(x, dtype), cast(mod.weight, dtype), b, mod.stride,
                    mod.padding)


def s2d_stem_kernel(w: torch.Tensor) -> torch.Tensor:
    """The 7x7/s2 stem kernel [O, C, 7, 7] as the 4x4/s1 kernel [O, 4C, 4,
    4] of the space-to-depth image (JAX `StemConv`): tap ty lands in
    cell ay = (ty - 3) // 2 + 2 at parity by = (ty - 3) % 2, channel
    block (by * 2 + bx) * C; the one position of no tap (cell 0, parity
    0) is zero. A padding and a reshape, so gradients reach `w`."""
    o, c = w.shape[:2]
    # padded by one at the top and left, tap ty sits at row ty + 1 =
    # 2 * ay + by
    wp = F.pad(w, (1, 0, 1, 0)).reshape(o, c, 4, 2, 4, 2)
    return wp.permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4)


def stem_conv(x: torch.Tensor, w: torch.Tensor, s2d: bool) -> torch.Tensor:
    """JAX `StemConv` on an NCHW image `x` and the 7x7 kernel `w` (OIHW),
    both already in the compute type: with `s2d` and even H and W the
    image rearranged to 4C channels at half resolution (channel (py * 2 +
    px) * C + c) and the 4x4 kernel of `s2d_stem_kernel` at stride 1,
    padded (2, 1) on each axis; else the 7x7 conv at stride 2, padding
    3. The two compute the same function, summed in other orders."""
    n, c, h, wd = x.shape
    if not s2d or h % 2 or wd % 2:
        return F.conv2d(x, w, stride=2, padding=3)
    xs = x.reshape(n, c, h // 2, 2, wd // 2, 2).permute(0, 3, 5, 1, 2, 4)
    xs = xs.reshape(n, 4 * c, h // 2, wd // 2)
    return F.conv2d(F.pad(xs, (2, 1, 2, 1)), s2d_stem_kernel(w))


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

    def _forward(self, x: torch.Tensor, dtype, bn):
        """NCHW x -> y, each BatchNorm by bn(name, map)."""
        out = torch.relu(bn("bn1", _conv(self.conv1, x, dtype)))
        out = torch.relu(bn("bn2", _conv(self.conv2, out, dtype)))
        out = bn("bn3", _conv(self.conv3, out, dtype))
        identity = x
        if self.has_downsample:
            identity = bn("downsample_bn",
                          _conv(self.downsample_conv, x, dtype))
        return torch.relu(out + identity)

    def forward_train(self, x: torch.Tensor, dtype):
        """NCHW x -> (y, the batch statistics of bn1, bn2, bn3[,
        downsample_bn])."""
        stats = []

        def bn(name, t):
            y, st = batch_norm_train(t, getattr(self, name), dtype)
            stats.append(st)
            return y

        return self._forward(x, dtype, bn), tuple(stats)

    def forward_module(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """NCHW x -> y at inference, BatchNorm on the running
        statistics."""
        return self._forward(
            x, dtype,
            lambda name, t: batch_norm_infer(t, getattr(self, name), dtype))

    def bn_names(self) -> Tuple[str, ...]:
        return ("bn1", "bn2", "bn3") + (
            ("downsample_bn",) if self.has_downsample else ())


class _FoldCache(nn.Module):
    """Caches derived inference tensors per (device, dtype); loading a
    state dict drops the cache. Under `torch.export` the cache is
    neither read nor filled: the derived tensors are built in the traced
    graph from the parameters, so the exported program folds its own
    weights and the cache never holds a traced tensor."""

    def __init__(self):
        super().__init__()
        self._cache: Dict[tuple, object] = {}
        self._register_load_state_dict_pre_hook(self._drop_cache)

    def _drop_cache(self, *args, **kwargs):
        self._cache.clear()

    def _cached(self, device, dtype, build):
        if torch.compiler.is_exporting():  # inside the model's no_grad
            return build()
        key = (str(device), dtype)
        if key not in self._cache:
            with torch.no_grad():
                self._cache[key] = build()
        return self._cache[key]


class ResNet(_FoldCache):
    """ResNet-50/101 trunk returning C2..C5 maps (NHWC). `stem_s2d` is
    JAX's: the module trunks' stem takes the space-to-depth conv (the
    fused trunk is never served with it)."""

    def __init__(self, depth: int = 50, stem_s2d: bool = False):
        super().__init__()
        self.depth = depth
        self.stem_s2d = stem_s2d
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
            stem_w = self.conv1.weight.to(dtype).float()
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
            return stem_w, stem_f, stem_b, blocks

        return self._cached(device, dtype, build)

    def stem(self, x: torch.Tensor, dtype=torch.float32):
        """x: [N, H, W, 3] -> the stem's [N, H/2, W/2, 64] map in `dtype`,
        before the max-pool: the conv of the image and the kernel, both
        rounded to `dtype`, summed in fp32, then the folded BN, the
        rounding to `dtype` and the ReLU."""
        stem_w, stem_f, stem_b, _ = self.folded(x.device, dtype)
        with _ieee_fp32_conv():
            y = F.conv2d(x.to(dtype).float().permute(0, 3, 1, 2), stem_w,
                         stride=2, padding=3).permute(0, 2, 3, 1)
        return torch.relu((y * stem_f + stem_b).to(dtype)).contiguous()

    def forward(self, x: torch.Tensor, dtype=torch.float32):
        """x: [N, H, W, 3] -> four NHWC maps (strides 4, 8, 16, 32)."""
        blocks = self.folded(x.device, dtype)[3]
        x = maxpool_3x3_s2_fused(self.stem(x, dtype))
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


    def _stem_module(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """NHWC image -> the NCHW stem conv in `dtype` (JAX `StemConv`)."""
        return stem_conv(x.to(dtype).permute(0, 3, 1, 2),
                         self.conv1.weight.to(dtype), self.stem_s2d)

    def _blocks(self, x: torch.Tensor, run) -> List[torch.Tensor]:
        """The bottlenecks from the pooled NCHW stem map, each through
        run(block, x); the four stage outputs, NHWC."""
        outs = []
        idx = 0
        for num_blocks in RESNET_STAGE_BLOCKS[self.depth]:
            for _ in range(num_blocks):
                x = run(getattr(self, self.block_names[idx]), x)
                idx += 1
            outs.append(x.permute(0, 2, 3, 1))
        return outs

    def forward_module(self, x: torch.Tensor,
                       dtype=torch.float32) -> List[torch.Tensor]:
        """The module trunk at inference (JAX `ResNet.__call__(train=
        False)`): x [N, H, W, 3] -> four NHWC maps in `dtype`. The maps
        stay channels-last in memory (cuDNN's layout for NHWC)."""
        y = torch.relu(batch_norm_infer(self._stem_module(x, dtype),
                                        self.bn1, dtype))
        x = maxpool_3x3_s2_fused(y.permute(0, 2, 3, 1).contiguous())
        return self._blocks(x.permute(0, 3, 1, 2),
                            lambda blk, t: blk.forward_module(t, dtype))

    def forward_train(self, x: torch.Tensor, dtype=torch.float32,
                      remat: bool = False) -> List[torch.Tensor]:
        """Training trunk: x [N, H, W, 3] -> four NHWC maps in `dtype`,
        the running statistics updated from this batch."""
        y, st = batch_norm_train(self._stem_module(x, dtype), self.bn1,
                                 dtype)
        update_running_stats(self.bn1, st)
        x = F.max_pool2d(torch.relu(y), 3, 2, 1)

        def run(blk, t):
            if remat and torch.is_grad_enabled():
                t, stats = checkpoint.checkpoint(
                    blk.forward_train, t, dtype, use_reentrant=False)
            else:
                t, stats = blk.forward_train(t, dtype)
            for name, st in zip(blk.bn_names(), stats):
                update_running_stats(getattr(blk, name), st)
            return t

        return self._blocks(x, run)


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

    def forward_train(self, inputs: Sequence[torch.Tensor],
                      dtype=torch.float32) -> List[torch.Tensor]:
        """The module FPN on plain convs in `dtype` (NHWC in and out)."""
        laterals = [
            _conv(getattr(self, f"lateral_{i}"), x.permute(0, 3, 1, 2),
                  dtype).permute(0, 2, 3, 1)
            for i, x in enumerate(inputs)
        ]
        for i in range(len(laterals) - 1, 0, -1):
            up = upsample2x_nearest(laterals[i], laterals[i - 1].shape[1:3])
            laterals[i - 1] = laterals[i - 1] + up
        return [
            _conv(getattr(self, f"fpn_{i}"), lat.permute(0, 3, 1, 2),
                  dtype).permute(0, 2, 3, 1)
            for i, lat in enumerate(laterals)
        ]


class DenseDepthNet(nn.Module):
    """Training-only per-level 1x1-conv depth head: `exp()` of an fp32
    1x1 conv, scaled by focal / equal_focal."""

    def __init__(self, num_depth_layers: int = 3, in_channels: int = 256,
                 equal_focal: float = 100.0):
        super().__init__()
        self.num_depth_layers = num_depth_layers
        self.equal_focal = equal_focal
        for i in range(num_depth_layers):
            self.add_module(f"depth_layer_{i}",
                            nn.Conv2d(in_channels, 1, 1))

    def forward(self, feature_maps: Sequence[torch.Tensor],
                focal: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """feature_maps: per level [bs, cams, H, W, C]; focal [bs, cams]
        -> per level [bs, cams, H, W] float32."""
        depths = []
        for i, feat in enumerate(feature_maps[: self.num_depth_layers]):
            bs, cams, h, w, c = feat.shape
            x = feat.float().reshape(bs * cams, h, w, c).permute(0, 3, 1, 2)
            d = torch.exp(_conv(getattr(self, f"depth_layer_{i}"), x,
                                torch.float32))[:, 0].reshape(bs, cams, h, w)
            if focal is not None:
                d = d * (focal[:, :, None, None] / self.equal_focal)
            depths.append(d)
        return depths
