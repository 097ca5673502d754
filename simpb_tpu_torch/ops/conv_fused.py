"""Fused ResNet-trunk inference ops: the CUDA kernels and their plain
PyTorch versions.

Port of `simpb_tpu/ops/conv_fused.py`. Four ops, each a hand-written
CUDA kernel for Hopper in `csrc/conv_fused.cu` (see the notes there on
what bounds each one and how the design answers it):

* `maxpool_3x3_s2_fused` — 3x3/s2/p1 max-pool, -inf padding (K1);
* `bottleneck_down_fused_infer` — stage-head bottleneck with the strided
  1x1 downsample skip, stride 1 or 2, one launch (K2);
* `bottleneck_fused_infer` — stride-1 bottleneck with identity residual,
  one launch (K3);
* `conv3x3_bias_fused` — same-padding 3x3 conv + bias (K4).

Activations are NHWC, weights HWIO / [in, out] with BatchNorm folded
(`fold_block_params`). A wrapper runs its plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
Each wrapper counts its kernel launches in its `launches` attribute.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _kernels

BN_EPS = 1e-5  # torch BatchNorm default; the JAX package folds with it too
KC = 16  # channel granularity of the CUDA kernels' weight chunks
MAX_COLS = 256  # widest block tile of the CUDA kernels' products

Folded = Tuple[torch.Tensor, ...]


# ----------------------------------------------------------------------
# BatchNorm folding (simpb_tpu/ops/conv_fused.py:60-88, 174-179)
# ----------------------------------------------------------------------
def fold_bn(bn: torch.nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale f, bias b) in float32 with BN(x) == x * f + b at inference."""
    f = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
    return f, bn.bias.float() - bn.running_mean.float() * f


def _fold_conv(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d):
    """BN-folded conv kernel in HWIO layout plus bias, float32."""
    f, b = fold_bn(bn)
    return conv.weight.float().permute(2, 3, 1, 0) * f, b


def fold_block_params(block) -> Folded:
    """(w1 [C, Cm], b1, w2 [3, 3, Cm, Cm], b2, w3 [Cm, Co], b3), float32."""
    k1, b1 = _fold_conv(block.conv1, block.bn1)
    k2, b2 = _fold_conv(block.conv2, block.bn2)
    k3, b3 = _fold_conv(block.conv3, block.bn3)
    return k1[0, 0], b1, k2, b2, k3[0, 0], b3


def fold_downsample_params(block) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wd [C, Co], bd) of a stage-head block's skip projection."""
    k, b = _fold_conv(block.downsample_conv, block.downsample_bn)
    return k[0, 0], b


# ----------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference on the card)
# ----------------------------------------------------------------------
def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1,
          padding: int = 0) -> torch.Tensor:
    """NHWC conv through F.conv2d (HWIO weights)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _as_storage(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight rounded to the storage type, held in float32 so that the
    plain version's products and sums run in fp32 like the kernels'."""
    return w.to(dtype).float()


def maxpool_3x3_s2_plain(x: torch.Tensor) -> torch.Tensor:
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def bottleneck_plain(
    x: torch.Tensor,
    folded: Folded,
    folded_down: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    stride: int = 1,
) -> torch.Tensor:
    """One bottleneck with the kernels' rounding points: y1 and y2 are
    stored in x.dtype; with the identity residual y3 is rounded to
    x.dtype before the add; with a downsample skip the add is fp32."""
    cdt = x.dtype
    w1, b1, w2, b2, w3, b3 = folded
    xf = x.float()
    y1 = torch.relu(_conv(xf, _as_storage(w1, cdt)[None, None]) + b1)
    y1 = y1.to(cdt)
    y2 = torch.relu(
        _conv(y1.float(), _as_storage(w2, cdt), stride, 1) + b2
    ).to(cdt)
    y3 = _conv(y2.float(), _as_storage(w3, cdt)[None, None]) + b3
    if folded_down is None:
        return torch.relu(y3.to(cdt) + x).contiguous()
    wd, bd = folded_down
    xd = _conv(xf, _as_storage(wd, cdt)[None, None], stride) + bd
    return torch.relu(y3 + xd).to(cdt).contiguous()


def conv3x3_bias_plain(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    cdt = x.dtype
    y = _conv(x.float(), _as_storage(kernel, cdt), 1, 1) + bias.float()
    return y.to(cdt).contiguous()


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def _check_act(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _kernels.DTYPE_CODE:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous NHWC tensor, got "
                         f"shape {tuple(x.shape)}")


def _param(t: torch.Tensor, like: torch.Tensor, dtype: torch.dtype,
           shape: Sequence[int], what: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.to(device=like.device, dtype=dtype).contiguous()


def _smem_bytes(region_px: int, tile_px: int, channels: int,
                itemsize: int) -> int:
    """Dynamic shared memory of a launch, laid out as the CUDA kernels lay
    it out: one KC x MAX_COLS fp32 weight chunk, then region_px + tile_px
    pixels of `channels` values in the storage type (a bottleneck's y1
    over its halo region and its y2 tile; the 3x3 conv's input halo)."""
    return KC * MAX_COLS * 4 + (region_px + tile_px) * channels * itemsize


def _bottleneck_tile(h: int, w: int, cm: int, stride: int, itemsize: int):
    """Output tile of a fused bottleneck: 8x8 up to 128 mid channels,
    4x4 above, halved while the shared memory does not fit."""
    def smem(t):
        return _smem_bytes(((t - 1) * stride + 3) ** 2, t * t, cm, itemsize)

    t = 8 if cm <= 128 else 4
    while t > 1 and smem(t) > _kernels.MAX_SMEM:
        t //= 2
    if smem(t) > _kernels.MAX_SMEM:
        raise ValueError(f"bottleneck with {cm} mid channels does not fit "
                         "in shared memory")
    return min(t, h), min(t, w)


def maxpool_3x3_s2_fused(x: torch.Tensor) -> torch.Tensor:
    """3x3/s2/p1 max-pool of an NHWC map, [B, H, W, C] ->
    [B, ceil(H/2), ceil(W/2), C]."""
    if x.device.type == "cpu":
        return maxpool_3x3_s2_plain(x)
    _check_act(x, "maxpool_3x3_s2_fused")
    b, h, w, c = x.shape
    y = torch.empty((b, (h + 1) // 2, (w + 1) // 2, c), dtype=x.dtype,
                    device=x.device)
    lib = _kernels.load("conv_fused")
    code = lib.simpb_maxpool_3x3_s2(
        _kernels.ptr(x), _kernels.ptr(y), b, h, w, c,
        _kernels.DTYPE_CODE[x.dtype], ctypes.c_void_p(_kernels.stream_ptr(x)),
    )
    _kernels.check(code, "maxpool_3x3_s2_fused")
    maxpool_3x3_s2_fused.launches += 1
    return y


def _bottleneck_cuda(x, folded, folded_down, stride, what):
    _check_act(x, what)
    b, h, w, c = x.shape
    cdt = x.dtype
    w1, b1, w2, b2, w3, b3 = folded
    cm, co = w1.shape[1], w3.shape[1]
    if stride not in (1, 2) or h % stride or w % stride:
        raise ValueError(f"{what}: stride {stride} needs H and W divisible "
                         f"by it, got {h}x{w}")
    if c % KC or cm % KC or co % KC:
        raise ValueError(f"{what}: channel counts must be multiples of "
                         f"{KC}, got {c}/{cm}/{co}")
    f32 = torch.float32
    w1 = _param(w1, x, cdt, (c, cm), what)
    w2 = _param(w2, x, cdt, (3, 3, cm, cm), what)
    w3 = _param(w3, x, cdt, (cm, co), what)
    b1 = _param(b1, x, f32, (cm,), what)
    b2 = _param(b2, x, f32, (cm,), what)
    b3 = _param(b3, x, f32, (co,), what)
    wd = bd = None
    if folded_down is not None:
        wd = _param(folded_down[0], x, cdt, (c, co), what)
        bd = _param(folded_down[1], x, f32, (co,), what)
    elif co != c or stride != 1:
        raise ValueError(f"{what}: identity residual needs C == Co, stride 1")
    oh, ow = h // stride, w // stride
    th, tw = _bottleneck_tile(oh, ow, cm, stride, x.element_size())
    y = torch.empty((b, oh, ow, co), dtype=cdt, device=x.device)
    lib = _kernels.load("conv_fused")
    code = lib.simpb_bottleneck(
        *map(_kernels.ptr, (x, w1, b1, w2, b2, w3, b3, wd, bd, y)),
        b, h, w, c, cm, co, stride, th, tw,
        _kernels.DTYPE_CODE[cdt], ctypes.c_void_p(_kernels.stream_ptr(x)),
    )
    _kernels.check(code, what)
    return y


def bottleneck_fused_infer(x: torch.Tensor, folded: Folded) -> torch.Tensor:
    """One stride-1 bottleneck with identity residual, [B, H, W, C] ->
    [B, H, W, C]; compute in x.dtype with fp32 accumulation."""
    if x.device.type == "cpu":
        return bottleneck_plain(x, folded)
    y = _bottleneck_cuda(x, folded, None, 1, "bottleneck_fused_infer")
    bottleneck_fused_infer.launches += 1
    return y


def bottleneck_down_fused_infer(
    x: torch.Tensor,
    folded: Folded,
    folded_down: Tuple[torch.Tensor, torch.Tensor],
    stride: int,
) -> torch.Tensor:
    """One stage-head bottleneck (strided 1x1 downsample skip)."""
    if x.device.type == "cpu":
        return bottleneck_plain(x, folded, folded_down, stride)
    y = _bottleneck_cuda(x, folded, folded_down, stride,
                         "bottleneck_down_fused_infer")
    bottleneck_down_fused_infer.launches += 1
    return y


def conv3x3_bias_fused(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Same-padding 3x3 conv + bias; kernel [3, 3, C, Co], bias [Co]."""
    if x.device.type == "cpu":
        return conv3x3_bias_plain(x, kernel, bias)
    what = "conv3x3_bias_fused"
    _check_act(x, what)
    b, h, w, c = x.shape
    co = kernel.shape[-1]
    if c % KC:
        raise ValueError(f"{what}: C must be a multiple of {KC}, got {c}")
    kernel = _param(kernel, x, x.dtype, (3, 3, c, co), what)
    bias = _param(bias, x, torch.float32, (co,), what)
    th, tw = min(8, h), min(8, w)
    while th > 1 and _smem_bytes((th + 2) * (tw + 2), 0, c,
                                 x.element_size()) > _kernels.MAX_SMEM:
        th, tw = max(1, th // 2), max(1, tw // 2)
    y = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    lib = _kernels.load("conv_fused")
    code = lib.simpb_conv3x3_bias(
        *map(_kernels.ptr, (x, kernel, bias, y)), b, h, w, c, co, th, tw,
        _kernels.DTYPE_CODE[x.dtype], ctypes.c_void_p(_kernels.stream_ptr(x)),
    )
    _kernels.check(code, what)
    conv3x3_bias_fused.launches += 1
    return y


# the kernels of this module: (name, wrapper, plain version, the Pallas
# kernel it replaces)
KERNELS = (
    ("maxpool_3x3_s2", maxpool_3x3_s2_fused, maxpool_3x3_s2_plain,
     "simpb_tpu/ops/conv_fused.py:445"),
    ("bottleneck_down", bottleneck_down_fused_infer, bottleneck_plain,
     "simpb_tpu/ops/conv_fused.py:214"),
    ("bottleneck", bottleneck_fused_infer, bottleneck_plain,
     "simpb_tpu/ops/conv_fused.py:117"),
    ("conv3x3_bias", conv3x3_bias_fused, conv3x3_bias_plain,
     "simpb_tpu/ops/conv_fused.py:364"),
)
for _name, _wrapper, _plain, _tpu in KERNELS:
    _wrapper.launches = 0


def reset_launch_counts() -> None:
    for _, wrapper, _, _ in KERNELS:
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, wrapper, _, _ in KERNELS}
