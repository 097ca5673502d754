"""Fused ResNet-trunk inference ops: the CUDA kernels and their plain
PyTorch versions.

Port of `simpb_tpu/ops/conv_fused.py`. Four ops, each a hand-written
CUDA kernel for Hopper in `csrc/conv_fused.cu`; in bf16, K2, K3 and K4
run on the tensor cores instead, `csrc/conv_tc.cu`, with their tiles
chosen by the planner below (`plan_bottleneck_down_tc`,
`plan_bottleneck_tc`, `plan_conv3x3_tc`). The kernel is picked by dtype
alone; a bf16 shape the planner refuses raises `ValueError`. See the
sources' notes on what bounds each kernel and how its design answers it:

* `maxpool_3x3_s2_fused` — 3x3/s2/p1 max-pool, -inf padding (K1);
* `bottleneck_down_fused_infer` — stage-head bottleneck with the strided
  1x1 downsample skip, stride 1 or 2, one launch (K2);
* `bottleneck_fused_infer` — stride-1 bottleneck with identity residual,
  one launch (K3);
* `conv3x3_bias_fused` — same-padding 3x3 conv + bias (K4).

Activations are NHWC, weights HWIO / [in, out] with BatchNorm folded
(`fold_block_params`). Each wrapper calls its op, a
`torch.library.custom_op` named `simpb::<kernel>` with a fake (shape)
implementation, so that `torch.export` keeps the launch in its graph
(`utils/export.py`). The op runs the plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises. Each
wrapper counts its kernel launches in its `launches` attribute.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

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
def _check_device(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")


def _check_act(x: torch.Tensor, what: str) -> None:
    _check_device(x, what)
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


def _smem_bytes(region_px: int, tile_px: int, channels: int) -> int:
    """Dynamic shared memory of an fp32 launch of csrc/conv_fused.cu,
    laid out as its kernels lay it out: one KC x MAX_COLS weight chunk,
    then region_px + tile_px pixels of `channels` values (a bottleneck's
    y1 over its halo region and its y2 tile; the 3x3 conv's input
    halo)."""
    return (KC * MAX_COLS + (region_px + tile_px) * channels) * 4


def _bottleneck_tile(h: int, w: int, cm: int, stride: int):
    """Output tile of a fused fp32 bottleneck: 8x8 up to 128 mid
    channels, 4x4 above, halved while the shared memory does not fit."""
    def smem(t):
        return _smem_bytes(((t - 1) * stride + 3) ** 2, t * t, cm)

    t = 8 if cm <= 128 else 4
    while t > 1 and smem(t) > _kernels.MAX_SMEM:
        t //= 2
    if smem(t) > _kernels.MAX_SMEM:
        raise ValueError(f"bottleneck with {cm} mid channels does not fit "
                         "in shared memory")
    return min(t, h), min(t, w)


# ----------------------------------------------------------------------
# launch planner of the bf16 tensor-core kernels (csrc/conv_tc.cu)
# ----------------------------------------------------------------------
# The constants mirror conv_tc.cu: 256 threads (8 warps) a block, weight
# chunks bk rows deep in a ring of TC_STAGES stages, every shared-memory
# row padded by TC_PAD bf16; a warp owns a (16 mt) x 64 tile of a pass
# and a pass lays 8 warps out wm x (8 / wm).
TC_WARPS, TC_STAGES, TC_PAD = 8, 3, 8
TC_BK = (32, 64)  # chunk depths (conv_tc.cu instances)
TC_CHANNELS = 64  # every channel count must be a multiple of it
TC_MT = (1, 2, 4)  # 16-row sub-tiles a warp may own (conv_tc.cu instances)
TC_MT_DOWN = (2, 4)  # K2's: at mt 1 ptxas holds it to 128 registers (spills)
SMS = 132  # streaming multiprocessors of an H100 SXM
SM_SMEM = 228 * 1024  # shared memory of one SM; a block reserves 1 KB more
# Planning model, not a measurement: an SM reads shared memory at 128 B
# a clock (about 1.7 GHz). Three rates are fitted so that the model's
# picks come closest to the fastest of tools/conv_tc_sweep.py's timings
# of every plan of K2, K3 and K4 on the H100 (PERF.md): an SM sustains
# 35 % of its share of the bf16 peak with mma.sync, a weight chunk costs
# a block 0.6 us of barrier and pipeline latency, and the card serves
# 2 TB/s from L2.
# Blocks an SM holds by registers, from nvcc's -Xptxas -v report (about
# 64-128 registers for mt 1 and 2, 240 for mt 4, at 256 threads).
_SM_FLOPS, _SM_SMEM_BYTES = 989e12 / SMS * 0.35, 2.2e11
_CHUNK_S, _L2_BYTES = 6e-7, 2e12
_REG_BLOCKS = {1: 2, 2: 2, 4: 1}
_TILE_H, _TILE_W = (1, 2, 4, 8, 16), (8, 16)


class TcPlan(NamedTuple):
    """Tile and grid of one tensor-core launch: output tile th x tw;
    mt 16-row sub-tiles per warp; bk, the depth of a weight chunk; wm,
    the warp layout of each product (K4: one; K3: the reduce, the 3x3
    and the expansion; K2: the same three, the skip sharing the
    expansion's); the blocks of the grid and the dynamic shared memory
    (bytes) of each."""
    th: int
    tw: int
    mt: int
    bk: int
    wm: Tuple[int, ...]
    blocks: int
    smem: int


def tc_pass_shape(mt: int, wm: int) -> Tuple[int, int]:
    """(rows, columns) of one pass tile."""
    return 16 * mt * wm, 64 * (TC_WARPS // wm)


def _stage_elems(mt: int, wm: int, stream_a: bool, bk: int) -> int:
    bm, bn = tc_pass_shape(mt, wm)
    return (bm * (bk + TC_PAD) if stream_a else 0) + bk * (bn + TC_PAD)


def _pick_wm(mt: int, bk: int, m: int, n: int) -> int:
    """The warp layout of an m x n product: fewest padded rows, then
    fewest passes, then the smallest ring stage; its pass width must
    divide n."""
    def key(wm):
        bm, bn = tc_pass_shape(mt, wm)
        mp = -(-m // bm)
        return mp * bm, mp * (n // bn), _stage_elems(mt, wm, True, bk)

    return min((wm for wm in (1, 2, 4, 8)
                if n % tc_pass_shape(mt, wm)[1] == 0), key=key)


def _product_cost(mt, wm, bk, m, n, k, stream_a):
    """(MACs, bytes drawn from L2, bytes of ldmatrix reads, weight chunks)
    of one product in a block: per 16-deep step a warp loads mt A and 4 B
    8x8 quads of 512 B each."""
    bm, bn = tc_pass_shape(mt, wm)
    passes = -(-m // bm) * (n // bn)
    macs = passes * bm * bn * k
    l2 = passes * (k * bn + (bm * k if stream_a else 0)) * 2
    smem = passes * (k // 16) * TC_WARPS * (mt + 4) * 512
    return macs, l2, smem, passes * (k // bk)


def _estimate(blocks, costs, mt, smem_bytes):
    """Planning estimate of a launch's seconds: waves of blocks, each
    bound by its products or its shared-memory reads, the blocks an SM
    holds at once sharing it; or the launch's L2 traffic, if larger."""
    macs, l2, reads, chunks = (sum(c[i] for c in costs) for i in range(4))
    per_block = max(2 * macs / _SM_FLOPS, reads / _SM_SMEM_BYTES) \
        + chunks * _CHUNK_S
    per_sm = max(1, min(SM_SMEM // (smem_bytes + 1024), _REG_BLOCKS[mt]))
    if blocks > SMS:
        per_block *= -(-blocks // (SMS * per_sm)) * per_sm
    return max(per_block, blocks * l2 / _L2_BYTES), macs


def _check_tc_aligned(what, *tensors):
    """The tensor-core kernels copy 16 bytes at a time (cp.async)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: bf16 tensor-core kernel needs "
                             "16-byte aligned tensors")


def _check_tc_channels(what, **chans):
    for name, c in chans.items():
        if c % TC_CHANNELS:
            raise ValueError(f"{what}: bf16 tensor-core kernel needs {name} "
                             f"a multiple of {TC_CHANNELS}, got {c}")


def conv3x3_tc_plans(b: int, h: int, w: int, c: int, co: int):
    """Every plan of K4's bf16 kernel that fits, as (estimate, plan)."""
    _check_tc_channels("conv3x3_bias_fused", C=c, Co=co)
    out = []
    for th in _TILE_H:
        for tw in _TILE_W:
            for mt, bk, wm in itertools.product(TC_MT, TC_BK, (1, 2, 4, 8)):
                bm, bn = tc_pass_shape(mt, wm)
                if co % bn:
                    continue
                smem = 2 * ((th + 2) * (tw + 2) * (c + TC_PAD)
                            + TC_STAGES * _stage_elems(mt, wm, False, bk))
                if smem > _kernels.MAX_SMEM:
                    continue
                blocks = -(-h // th) * -(-w // tw) * (co // bn) * b
                halo = (0, (th + 2) * (tw + 2) * c * 2, 0, 0)
                est = _estimate(blocks, (_product_cost(
                    mt, wm, bk, th * tw, bn, 9 * c, False), halo), mt, smem)
                out.append((est + (smem,),
                            TcPlan(th, tw, mt, bk, (wm,), blocks, smem)))
    return out


def _y1_rows(th: int, tw: int, stride: int) -> int:
    """Shared-memory rows of a bottleneck's y1 (conv_tc.cu's Y1Rows): the
    (th + 2) x (tw + 2) region at stride 1; at stride 2 four parity
    planes tw + 1 rows wide over the (2 th + 1)-row region."""
    if stride == 1:
        return (th + 2) * (tw + 2)
    return 2 * (2 * th + 1) * (tw + 1)


def _bottleneck_plans(b, h, w, c, cm, co, stride, down):
    """Every plan of a bf16 bottleneck kernel (K2 with `down`, else K3)
    for an NHWC [b, h, w, c] input that fits, as (estimate, plan): one
    block per (output tile, image), all channels."""
    oh, ow = h // stride, w // stride
    out = []
    for th in _TILE_H:
        for tw in _TILE_W:
            p = th * tw
            rp = ((th - 1) * stride + 3) * ((tw - 1) * stride + 3)
            for mt, bk in itertools.product(TC_MT_DOWN if down else TC_MT,
                                            TC_BK):
                wm = (_pick_wm(mt, bk, rp, cm), _pick_wm(mt, bk, p, cm),
                      _pick_wm(mt, bk, p, co))
                stage = max(_stage_elems(mt, wm[0], True, bk),
                            _stage_elems(mt, wm[1], False, bk),
                            _stage_elems(mt, wm[2], down, bk))
                smem = 2 * ((_y1_rows(th, tw, stride) + p) * (cm + TC_PAD)
                            + TC_STAGES * stage)
                if smem > _kernels.MAX_SMEM:
                    continue
                blocks = -(-oh // th) * -(-ow // tw) * b
                costs = [_product_cost(mt, wm[0], bk, rp, cm, c, True),
                         _product_cost(mt, wm[1], bk, p, cm, 9 * cm, False),
                         _product_cost(mt, wm[2], bk, p, co, cm, False)]
                if down:  # the strided skip, streamed with the weights
                    costs.append(_product_cost(mt, wm[2], bk, p, co, c, True))
                est = _estimate(blocks, costs, mt, smem)
                out.append((est + (smem,),
                            TcPlan(th, tw, mt, bk, wm, blocks, smem)))
    return out


def bottleneck_tc_plans(b: int, h: int, w: int, c: int, cm: int):
    """Every plan of K3's bf16 kernel that fits, as (estimate, plan)."""
    _check_tc_channels("bottleneck_fused_infer", C=c, Cm=cm)
    return _bottleneck_plans(b, h, w, c, cm, c, 1, False)


def bottleneck_down_tc_plans(b: int, h: int, w: int, c: int, cm: int,
                             co: int, stride: int):
    """Every plan of K2's bf16 kernel that fits, as (estimate, plan), for
    an NHWC [b, h, w, c] input and a [b, h / stride, w / stride, co]
    output."""
    what = "bottleneck_down_fused_infer"
    _check_tc_channels(what, C=c, Cm=cm, Co=co)
    if stride not in (1, 2) or h % stride or w % stride:
        raise ValueError(f"{what}: stride {stride} needs H and W divisible "
                         f"by it, got {h}x{w}")
    return _bottleneck_plans(b, h, w, c, cm, co, stride, True)


@functools.lru_cache(maxsize=None)
def plan_conv3x3_tc(b: int, h: int, w: int, c: int, co: int) -> TcPlan:
    """Tiles of K4's bf16 kernel for an NHWC [b, h, w, c] input and co
    outputs: one block per (tile, pass-wide slice of co, image)."""
    plans = conv3x3_tc_plans(b, h, w, c, co)
    if not plans:
        raise ValueError(f"conv3x3_bias_fused: no bf16 tile fits C={c}")
    return min(plans)[1]


@functools.lru_cache(maxsize=None)
def plan_bottleneck_tc(b: int, h: int, w: int, c: int, cm: int) -> TcPlan:
    """Tiles of K3's bf16 kernel for an NHWC [b, h, w, c] input with cm
    mid channels: one block per (tile, image), all channels."""
    plans = bottleneck_tc_plans(b, h, w, c, cm)
    if not plans:
        raise ValueError(f"bottleneck_fused_infer: no bf16 tile fits "
                         f"Cm={cm}")
    return min(plans)[1]


@functools.lru_cache(maxsize=None)
def plan_bottleneck_down_tc(b: int, h: int, w: int, c: int, cm: int,
                            co: int, stride: int) -> TcPlan:
    """Tiles of K2's bf16 kernel for an NHWC [b, h, w, c] input with cm
    mid and co output channels at `stride`: one block per (output tile,
    image), all channels."""
    plans = bottleneck_down_tc_plans(b, h, w, c, cm, co, stride)
    if not plans:
        raise ValueError(f"bottleneck_down_fused_infer: no bf16 tile fits "
                         f"Cm={cm}")
    return min(plans)[1]


@torch.library.custom_op("simpb::maxpool_3x3_s2", mutates_args=())
def _maxpool_op(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return maxpool_3x3_s2_plain(x)
    _check_act(x, "maxpool_3x3_s2_fused")
    b, h, w, c = x.shape
    if not (0 < b <= 65535 and 0 < h * w * c < 2**31):
        raise ValueError("maxpool_3x3_s2_fused: the kernel takes 1 to "
                         "65535 maps of fewer than 2^31 values each, got "
                         f"{tuple(x.shape)}")
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


@_maxpool_op.register_fake
def _(x):
    b, h, w, c = x.shape
    return x.new_empty((b, (h + 1) // 2, (w + 1) // 2, c))


def maxpool_3x3_s2_fused(x: torch.Tensor) -> torch.Tensor:
    """3x3/s2/p1 max-pool of an NHWC map, [B, H, W, C] ->
    [B, ceil(H/2), ceil(W/2), C] (op `simpb::maxpool_3x3_s2`)."""
    _check_device(x, "maxpool_3x3_s2_fused")
    return _maxpool_op(x)


def _bottleneck_cuda(x, folded, folded_down, stride, what):
    """K2 or K3 in fp32 on the CUDA cores (csrc/conv_fused.cu)."""
    b, h, w, c = x.shape
    w1, b1, w2, b2, w3, b3 = folded
    cm, co = w1.shape[1], w3.shape[1]
    if stride not in (1, 2) or h % stride or w % stride:
        raise ValueError(f"{what}: stride {stride} needs H and W divisible "
                         f"by it, got {h}x{w}")
    if c % KC or cm % KC or co % KC:
        raise ValueError(f"{what}: channel counts must be multiples of "
                         f"{KC}, got {c}/{cm}/{co}")
    f32 = torch.float32
    w1 = _param(w1, x, f32, (c, cm), what)
    w2 = _param(w2, x, f32, (3, 3, cm, cm), what)
    w3 = _param(w3, x, f32, (cm, co), what)
    b1 = _param(b1, x, f32, (cm,), what)
    b2 = _param(b2, x, f32, (cm,), what)
    b3 = _param(b3, x, f32, (co,), what)
    wd = bd = None
    if folded_down is not None:
        wd = _param(folded_down[0], x, f32, (c, co), what)
        bd = _param(folded_down[1], x, f32, (co,), what)
    elif co != c or stride != 1:
        raise ValueError(f"{what}: identity residual needs C == Co, stride 1")
    oh, ow = h // stride, w // stride
    th, tw = _bottleneck_tile(oh, ow, cm, stride)
    y = torch.empty((b, oh, ow, co), dtype=x.dtype, device=x.device)
    lib = _kernels.load("conv_fused")
    code = lib.simpb_bottleneck(
        *map(_kernels.ptr, (x, w1, b1, w2, b2, w3, b3, wd, bd, y)),
        b, h, w, c, cm, co, stride, th, tw,
        _kernels.DTYPE_CODE[x.dtype], ctypes.c_void_p(_kernels.stream_ptr(x)),
    )
    _kernels.check(code, what)
    return y


def _bottleneck_tc(x, folded, folded_down, stride, what):
    """K2 (with `folded_down`) or K3 in bf16 on the tensor cores
    (csrc/conv_tc.cu)."""
    b, h, w, c = x.shape
    w1, b1, w2, b2, w3, b3 = folded
    cm, co = w1.shape[1], w3.shape[1]
    if folded_down is None:
        plan = plan_bottleneck_tc(b, h, w, c, cm)
        co = c
    else:
        plan = plan_bottleneck_down_tc(b, h, w, c, cm, co, stride)
    bf, f32 = torch.bfloat16, torch.float32
    folded = (_param(w1, x, bf, (c, cm), what),
              _param(b1, x, f32, (cm,), what),
              _param(w2, x, bf, (3, 3, cm, cm), what),
              _param(b2, x, f32, (cm,), what),
              _param(w3, x, bf, (cm, co), what),
              _param(b3, x, f32, (co,), what))
    y = torch.empty((b, h // stride, w // stride, co), dtype=bf,
                    device=x.device)
    if folded_down is None:
        _check_tc_aligned(what, x, folded[0], folded[2], folded[4], y)
        code = launch_bottleneck_tc(x, folded, y, plan)
    else:
        down = (_param(folded_down[0], x, bf, (c, co), what),
                _param(folded_down[1], x, f32, (co,), what))
        _check_tc_aligned(what, x, folded[0], folded[2], folded[4], down[0],
                          y)
        code = launch_bottleneck_down_tc(x, folded, down, y, stride, plan)
    _kernels.check(code, what)
    return y


def launch_bottleneck_tc(x, folded, y, plan: TcPlan) -> int:
    """Launch K3's bf16 kernel with `plan` on prepared tensors (bf16
    weights, fp32 biases, all contiguous on x's card); returns the CUDA
    error code."""
    b, h, w, c = x.shape
    return _kernels.load("conv_tc").simpb_bottleneck_tc(
        *map(_kernels.ptr, (x, *folded, y)), b, h, w, c, folded[0].shape[1],
        plan.th, plan.tw, plan.mt, plan.bk, *plan.wm, plan.smem,
        ctypes.c_void_p(_kernels.stream_ptr(x)))


def launch_bottleneck_down_tc(x, folded, folded_down, y, stride: int,
                              plan: TcPlan) -> int:
    """Launch K2's bf16 kernel with `plan` on prepared tensors (bf16
    weights, fp32 biases, all contiguous on x's card); returns the CUDA
    error code."""
    b, h, w, c = x.shape
    return _kernels.load("conv_tc").simpb_bottleneck_down_tc(
        *map(_kernels.ptr, (x, *folded, *folded_down, y)), b, h, w, c,
        folded[0].shape[1], y.shape[-1], stride, plan.th, plan.tw, plan.mt,
        plan.bk, *plan.wm, plan.smem, ctypes.c_void_p(_kernels.stream_ptr(x)))


def launch_conv3x3_tc(x, kernel, bias, y, plan: TcPlan) -> int:
    """Launch K4's bf16 kernel with `plan` on prepared tensors; returns
    the CUDA error code."""
    b, h, w, c = x.shape
    return _kernels.load("conv_tc").simpb_conv3x3_tc(
        *map(_kernels.ptr, (x, kernel, bias, y)), b, h, w, c, y.shape[-1],
        plan.th, plan.tw, plan.mt, plan.bk, *plan.wm, plan.smem,
        ctypes.c_void_p(_kernels.stream_ptr(x)))


@torch.library.custom_op("simpb::bottleneck", mutates_args=())
def _bottleneck_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                   b3: torch.Tensor) -> torch.Tensor:
    folded = (w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return bottleneck_plain(x, folded)
    what = "bottleneck_fused_infer"
    _check_act(x, what)
    if x.dtype == torch.bfloat16:
        y = _bottleneck_tc(x, folded, None, 1, what)
    else:
        y = _bottleneck_cuda(x, folded, None, 1, what)
    bottleneck_fused_infer.launches += 1
    return y


@_bottleneck_op.register_fake
def _(x, w1, b1, w2, b2, w3, b3):
    return torch.empty_like(x)


def bottleneck_fused_infer(x: torch.Tensor, folded: Folded) -> torch.Tensor:
    """One stride-1 bottleneck with identity residual, [B, H, W, C] ->
    [B, H, W, C]; compute in x.dtype with fp32 accumulation (op
    `simpb::bottleneck`). On the card bf16 runs on the tensor cores
    (csrc/conv_tc.cu), fp32 on the CUDA cores (csrc/conv_fused.cu)."""
    _check_device(x, "bottleneck_fused_infer")
    return _bottleneck_op(x, *folded)


@torch.library.custom_op("simpb::bottleneck_down", mutates_args=())
def _bottleneck_down_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                        b3: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
                        stride: int) -> torch.Tensor:
    folded, folded_down = (w1, b1, w2, b2, w3, b3), (wd, bd)
    if x.device.type == "cpu":
        return bottleneck_plain(x, folded, folded_down, stride)
    what = "bottleneck_down_fused_infer"
    _check_act(x, what)
    if x.dtype == torch.bfloat16:
        y = _bottleneck_tc(x, folded, folded_down, stride, what)
    else:
        y = _bottleneck_cuda(x, folded, folded_down, stride, what)
    bottleneck_down_fused_infer.launches += 1
    return y


@_bottleneck_down_op.register_fake
def _(x, w1, b1, w2, b2, w3, b3, wd, bd, stride):
    b, h, w, _ = x.shape
    return x.new_empty((b, h // stride, w // stride, w3.shape[-1]))


def bottleneck_down_fused_infer(
    x: torch.Tensor,
    folded: Folded,
    folded_down: Tuple[torch.Tensor, torch.Tensor],
    stride: int,
) -> torch.Tensor:
    """One stage-head bottleneck (strided 1x1 downsample skip), [B, H, W,
    C] -> [B, H / stride, W / stride, Co] (op `simpb::bottleneck_down`).
    On the card bf16 runs on the tensor cores (csrc/conv_tc.cu), fp32 on
    the CUDA cores (csrc/conv_fused.cu)."""
    _check_device(x, "bottleneck_down_fused_infer")
    return _bottleneck_down_op(x, *folded, *folded_down, stride)


@torch.library.custom_op("simpb::conv3x3_bias", mutates_args=())
def _conv3x3_op(x: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3x3_bias_plain(x, kernel, bias)
    what = "conv3x3_bias_fused"
    _check_act(x, what)
    b, h, w, c = x.shape
    co = kernel.shape[-1]
    if x.dtype == torch.bfloat16:
        plan = plan_conv3x3_tc(b, h, w, c, co)
    elif c % KC:
        raise ValueError(f"{what}: C must be a multiple of {KC}, got {c}")
    kernel = _param(kernel, x, x.dtype, (3, 3, c, co), what)
    bias = _param(bias, x, torch.float32, (co,), what)
    y = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        _check_tc_aligned(what, x, kernel, y)
        code = launch_conv3x3_tc(x, kernel, bias, y, plan)
    else:
        th, tw = min(8, h), min(8, w)
        while th > 1 and _smem_bytes((th + 2) * (tw + 2), 0,
                                     c) > _kernels.MAX_SMEM:
            th, tw = max(1, th // 2), max(1, tw // 2)
        code = _kernels.load("conv_fused").simpb_conv3x3_bias(
            *map(_kernels.ptr, (x, kernel, bias, y)), b, h, w, c, co, th,
            tw, _kernels.DTYPE_CODE[x.dtype],
            ctypes.c_void_p(_kernels.stream_ptr(x)))
    _kernels.check(code, what)
    conv3x3_bias_fused.launches += 1
    return y


@_conv3x3_op.register_fake
def _(x, kernel, bias):
    b, h, w, _ = x.shape
    return x.new_empty((b, h, w, kernel.shape[-1]))


def conv3x3_bias_fused(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Same-padding 3x3 conv + bias; kernel [3, 3, C, Co], bias [Co] (op
    `simpb::conv3x3_bias`). On the card bf16 runs on the tensor cores
    (csrc/conv_tc.cu), fp32 on the CUDA cores (csrc/conv_fused.cu)."""
    _check_device(x, "conv3x3_bias_fused")
    return _conv3x3_op(x, kernel, bias)


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
