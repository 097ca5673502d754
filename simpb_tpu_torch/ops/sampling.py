"""Deformable sampling ops in plain PyTorch.

Port of the serving path of `simpb_tpu/ops/sampling.py`:

* `deformable_aggregation` — fused multi-camera multi-scale bilinear
  sample + weighted sum (DFA), with `gather_capacity` valid-slot
  compaction;
* `msda_patch` / `_msda_patch_sel` — windowed multi-scale deformable
  attention with per-query top-k level selection and `raw_heads`
  output (the value projection is applied after sampling by the
  caller);
* `msda` — exact multi-scale deformable attention (the exact configs'
  2D cross-attention).

Sampling semantics, as in the JAX package: pixel position is
`loc * size - 0.5`; out-of-border bilinear corners weigh zero; DFA drops
a whole sample outside (0, 1). The JAX package reads its samples from a
"pair table" (two adjacent pixels per row, a row layout for the TPU
gather engine); every corner that layout fetches from a neighbouring
row carries zero weight, so sampling the pixels directly, with indices
clamped into range, gives the same values. Indices are always clamped
explicitly: unlike JAX gathers, torch indexing does not clamp.

On the TPU these ops were XLA gathers, not Pallas kernels. On Hopper
the forward of each is a hand-written CUDA kernel in `csrc/sampling.cu`:
`deformable_aggregation` and `_msda_patch_sel` are the wrappers, and
`deformable_aggregation_plain` / `_msda_patch_sel_plain` their plain
versions. A wrapper checks its arguments, runs the plain version only
for tensors on the CPU, and for CUDA tensors launches the kernel or
raises. Each wrapper counts its launches (`launch_counts()`); the count
lives in this module, so it holds even while a caller has rebound a
wrapper's name to record or reroute its calls.

The launch of each comes from a cached planner, `plan_dfa` and
`plan_msda_sel`: grid, threads, shared memory and the host int array
the C entry reads, built once per shape; a shape the kernels do not take
raises `ValueError`. bf16 values of MSDA-sel run on the tensor cores,
fp32 on the CUDA cores (the wrapper picks by dtype alone); DFA is one
kernel for both dtypes.

Training: the three wrappers are differentiable. On the CPU autograd
runs through the plain versions. On the card each is a
`torch.autograd.Function` whose backward is a kernel of its own
(`deformable_aggregation_backward`, kernel B: DFA's Function saves the
forward's capacity thresholds, so the backward keeps exactly the slots
the forward kept; `msda_patch_sel_backward`, kernel C, and
`msda_backward`, kernel D: the Function saves only its inputs and the
kernel recomputes the windows or the samples). None uses atomics: each
feature or value gradient element has one owner block, which sums it in
fp32 in a fixed order, rounds it once to the features' dtype and writes
it once, so repeat launches give the same bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _kernels
from .format import SpatialShapes

MAX_LEVELS = 8  # level table of the CUDA kernels
MAX_HEADS = 16  # heads of the fp32 MSDA-sel kernel's per-thread sums
MAX_GROUPS = 8  # DFA weight groups
DFA_THREADS = 256  # most threads of a DFA block
# C1 packs a window's base in 14 bits an axis, B1 a corner's in 16
MAX_LEVEL_SIDE = 1 << 14
MSDA_THREADS = 256  # threads of an MSDA-sel tensor-core block
# the bf16 MSDA-sel kernel's head shape (csrc/sampling.cu): top-2 levels,
# 8x8 windows, 4 points a head (and at most 8 heads), as in every
# configuration of the repo
MSDA_TC_SHAPE = (2, 8, 8, 4)
_LAUNCHES = {"deformable_aggregation": 0, "msda_patch_sel": 0, "msda": 0,
             "deformable_aggregation_backward": 0,
             "msda_patch_sel_backward": 0, "msda_backward": 0}


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, sorted descending, the lower index
    first among ties (the order `jax.lax.top_k` gives)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot; indices outside [0, n) give a zero row (as
    `jax.nn.one_hot`)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _corner_weights(loc, h, w, dtype, drop_out_of_range):
    """Bilinear corner weights with border masking (weights in `dtype`)."""
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    lx = (x - x0f).to(dtype)
    ly = (y - y0f).to(dtype)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x1 = x0 + 1
    y1 = y0 + 1
    one = torch.ones((), dtype=dtype, device=loc.device)
    wx0 = (one - lx) * ((x0 >= 0) & (x0 < w)).to(dtype)
    wx1 = lx * ((x1 >= 0) & (x1 < w)).to(dtype)
    wy0 = (one - ly) * ((y0 >= 0) & (y0 < h)).to(dtype)
    wy1 = ly * ((y1 >= 0) & (y1 < h)).to(dtype)
    if drop_out_of_range:
        in_range = (
            (loc[..., 0] > 0.0) & (loc[..., 0] < 1.0)
            & (loc[..., 1] > 0.0) & (loc[..., 1] < 1.0)
        ).to(dtype)
        wy0 = wy0 * in_range
        wy1 = wy1 * in_range
    return wx0, wx1, wy0, wy1, x0, y0, y1


def _take_rows(table, rows):
    """Rows of a flat [R, C] table: rows [...] -> [..., C], indices
    clamped into range (torch indexing does not clamp)."""
    rows = rows.clamp(0, table.shape[0] - 1)
    return table.index_select(0, rows.reshape(-1)).reshape(
        rows.shape + (table.shape[-1],)
    )


def _sample_rows(table, base, h, w, loc, drop_out_of_range):
    """Bilinear samples of one level read straight from a flat
    [R, C] table: `base` [B, 1] is each batch row's level start.
    Returns (sample [B, N, C], wx0, wx1, wy0, wy1) in table.dtype."""
    wx0, wx1, wy0, wy1, x0, y0, y1 = _corner_weights(
        loc, h, w, table.dtype, drop_out_of_range
    )
    xc0 = x0.clamp(0, w - 1)
    xc1 = (x0 + 1).clamp(0, w - 1)
    r0 = base + y0.clamp(0, h - 1) * w
    r1 = base + y1.clamp(0, h - 1) * w
    take = lambda rows: _take_rows(table, rows)
    e = lambda t: t[..., None]
    vx0 = e(wx0) * take(r0 + xc0) + e(wx1) * take(r0 + xc1)
    vx1 = e(wx0) * take(r1 + xc0) + e(wx1) * take(r1 + xc1)
    return e(wy0) * vx0 + e(wy1) * vx1, wx0, wx1, wy0, wy1


def bilinear_sample(
    feat: torch.Tensor,  # [B, H*W, C]
    h: int,
    w: int,
    loc: torch.Tensor,  # [B, N, 2] (x, y) in (0, 1)
    drop_out_of_range: bool = True,
) -> torch.Tensor:
    """Reference-shape bilinear sampling of one level -> [B, N, C]."""
    b, hw, c = feat.shape
    base = (torch.arange(b, device=feat.device) * hw)[:, None]
    return _sample_rows(feat.reshape(b * hw, c), base, h, w, loc,
                        drop_out_of_range)[0]


def dfa_slots(points_2d: torch.Tensor, weights: torch.Tensor,
              gather_capacity: Optional[int] = None):
    """The (camera row, slot) samples DFA gathers: (loc [b, m, 2], w_all
    [b, m, L, G], sel_valid [b, m], slot [b, m]) with b = bs * cams and
    slot = a * P + p.

    With `gather_capacity` M < A*P, each camera keeps only its first M
    in-range (anchor, point) slots in slot order a * P + p (the score
    `in_range * 2s - arange` and a top-k, tie-free by construction);
    otherwise every slot, in range or not (`sel_valid` marks those that
    count)."""
    bs, num_anchor, num_pts, cams = points_2d.shape[:4]
    num_levels, num_groups = weights.shape[-2:]
    b = bs * cams
    s = num_anchor * num_pts
    dev = points_2d.device
    loc = points_2d.permute(0, 3, 1, 2, 4).reshape(b, s, 2)
    w_all = weights.permute(0, 3, 1, 2, 4, 5).reshape(
        b, s, num_levels, num_groups
    )
    in_range = (
        (loc[..., 0] > 0.0) & (loc[..., 0] < 1.0)
        & (loc[..., 1] > 0.0) & (loc[..., 1] < 1.0)
    )
    if gather_capacity is None or gather_capacity >= s:
        return loc, w_all, in_range, torch.arange(s, device=dev)[None].expand(
            b, s)
    m = gather_capacity
    score = in_range.float() * (2.0 * s) - torch.arange(
        s, dtype=torch.float32, device=dev
    )
    _, sel = topk_stable(score, m)  # [b, m]
    loc = torch.gather(loc, 1, sel[..., None].expand(b, m, 2))
    w_all = torch.gather(
        w_all, 1, sel[..., None, None].expand(b, m, num_levels, num_groups)
    )
    return loc, w_all, torch.gather(in_range, 1, sel), sel


def deformable_aggregation_plain(
    col_feats: torch.Tensor,  # [bs, cams, ΣHW, C]
    spatial_shapes: SpatialShapes,
    points_2d: torch.Tensor,  # [bs, A, P, cams, 2]
    weights: torch.Tensor,  # [bs, A, P, cams, L, G]
    gather_capacity: Optional[int] = None,
) -> torch.Tensor:
    """Fused multi-camera multi-scale deformable aggregation, plain
    PyTorch: each slot that `dfa_slots` keeps samples every level
    bilinearly (in the storage type), is weighted per group and sums
    into its anchor. Returns [bs, A, C] float32."""
    bs, cams, total_hw, c = col_feats.shape
    num_anchor = points_2d.shape[1]
    num_levels = spatial_shapes.num_levels
    num_groups = weights.shape[-1]
    group_dims = c // num_groups
    b = bs * cams
    dev = col_feats.device
    loc, w_all, sel_valid, slot = dfa_slots(points_2d, weights,
                                            gather_capacity)
    anchor_idx = slot // points_2d.shape[2]
    m = loc.shape[1]

    table = col_feats.reshape(b * total_hw, c)
    batch_base = (torch.arange(b, device=dev) * total_hw)[:, None]
    out_c = torch.zeros((b, m, c), dtype=torch.float32, device=dev)
    for lvl in range(num_levels):
        h_, w_ = spatial_shapes.shapes[lvl]
        start = spatial_shapes.start_indices[lvl]
        sampled = _sample_rows(table, batch_base + start, h_, w_, loc,
                               True)[0]  # [b, m, C] in the table dtype
        w_l = w_all[:, :, lvl].to(sampled.dtype)  # [b, m, G]
        w_exp = w_l[..., None].expand(b, m, num_groups, group_dims).reshape(
            b, m, c
        )
        out_c = out_c + (sampled * w_exp).float()

    # scatter the compacted slots back onto their anchors
    rows = (torch.arange(b, device=dev)[:, None] * num_anchor + anchor_idx)
    out = torch.zeros((b * num_anchor, c), dtype=torch.float32, device=dev)
    out.index_add_(0, rows.reshape(-1),
                   (out_c * sel_valid[..., None].float()).reshape(-1, c))
    return out.reshape(bs, cams, num_anchor, c).sum(dim=1)


def _check_devices(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: expected CPU or CUDA tensors, got {dev}")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")


def _check_aligned(what: str, t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned on the "
                         "card")


def _check_storage(what: str, t: torch.Tensor, name: str) -> None:
    if t.dtype not in _kernels.DTYPE_CODE:
        raise TypeError(f"{what}: {name} dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _check_levels(what: str, spatial_shapes: SpatialShapes,
                  total_hw: int) -> None:
    if spatial_shapes.num_levels > MAX_LEVELS:
        raise ValueError(f"{what}: at most {MAX_LEVELS} levels, got "
                         f"{spatial_shapes.num_levels}")
    if spatial_shapes.total != total_hw:
        raise ValueError(f"{what}: spatial shapes cover "
                         f"{spatial_shapes.total} rows, features {total_hw}")


class SamplingPlan(NamedTuple):
    """One launch of a sampling kernel: the blocks (x, y), the threads and
    dynamic shared memory (bytes) of a block, the int32 scratch the launch
    needs (DFA's rank pass: one count threshold a camera row), and the
    host int array the C entry reads (shapes, plan, level table), built
    once per shape."""
    grid: Tuple[int, int]
    threads: int
    smem: int
    scratch: int
    dims: ctypes.Array


def _level_table(shapes) -> list:
    """Level heights, widths and start rows as the kernels read them."""
    starts = [0]
    for h, w in shapes[:-1]:
        starts.append(starts[-1] + h * w)
    return [h for h, _ in shapes] + [w for _, w in shapes] + starts


@functools.lru_cache(maxsize=None)
def plan_dfa(bs: int, cams: int, num_anchor: int, num_pts: int,
             num_groups: int, c: int, gather_capacity: Optional[int],
             shapes: Tuple[Tuple[int, int], ...]) -> SamplingPlan:
    """DFA's launch for a [bs, cams, ΣHW, c] column over the levels
    `shapes`: one block per (anchor, batch) of DFA_THREADS // (c / 8)
    teams of c / 8 threads (a thread takes 8 channels of a feature row);
    the rank pass and its scratch when the capacity bites."""
    what = "deformable_aggregation"
    num_levels = len(shapes)
    if num_levels > MAX_LEVELS:
        raise ValueError(f"{what}: at most {MAX_LEVELS} levels, got "
                         f"{num_levels}")
    if num_groups > MAX_GROUPS or c % num_groups or (c // num_groups) % 8:
        raise ValueError(f"{what}: at most {MAX_GROUPS} groups, and channels "
                         f"per group C/G = {c}/{num_groups} a multiple of 8 "
                         "on the card")
    ch = c // 8
    teams = DFA_THREADS // ch
    while teams and (teams * ch) % 32:
        teams -= 1
    if not teams:
        raise ValueError(f"{what}: C = {c} channels do not fit a block of "
                         f"{DFA_THREADS} threads")
    threads = teams * ch
    entries = cams * num_pts * num_levels
    smem = 4 * (teams * c + 8 * entries + entries * num_groups)
    if smem > _kernels.MAX_SMEM:
        raise ValueError(f"{what}: {entries} samples per anchor do not fit "
                         "in shared memory")
    slots = num_anchor * num_pts
    cap = -1 if gather_capacity is None or gather_capacity >= slots \
        else gather_capacity
    total = sum(h * w for h, w in shapes)
    dims = [bs, cams, num_anchor, num_pts, num_levels, num_groups, c, total,
            cap, threads, smem] + _level_table(shapes)
    return SamplingPlan((num_anchor, bs), threads, smem,
                        bs * cams if cap >= 0 else 0,
                        _kernels.int_array(dims))


@functools.lru_cache(maxsize=None)
def _stride_array(strides: Tuple[int, ...]):
    return _kernels.int_array(strides, ctypes.c_longlong)


def _check_dfa(col_feats, spatial_shapes, points_2d, weights):
    what = "deformable_aggregation"
    _check_devices(what, col_feats, points_2d, weights)
    _check_storage(what, col_feats, "col_feats")
    if points_2d.dtype != col_feats.dtype or weights.dtype != col_feats.dtype:
        raise TypeError(f"{what}: points {points_2d.dtype} and weights "
                        f"{weights.dtype} must match col_feats "
                        f"{col_feats.dtype}")
    bs, cams, total_hw, c = col_feats.shape
    _, num_anchor, num_pts = points_2d.shape[:3]
    num_levels, num_groups = weights.shape[-2:]
    if (tuple(points_2d.shape) != (bs, num_anchor, num_pts, cams, 2)
            or tuple(weights.shape[:4]) != (bs, num_anchor, num_pts, cams)
            or num_levels != spatial_shapes.num_levels
            or c % num_groups):
        raise ValueError(f"{what}: shapes {tuple(col_feats.shape)}, "
                         f"{tuple(points_2d.shape)}, {tuple(weights.shape)} "
                         "do not fit together")
    _check_levels(what, spatial_shapes, total_hw)


def _dfa_plan(col_feats, spatial_shapes, points_2d, weights,
              gather_capacity):
    bs, cams, _, c = col_feats.shape
    num_anchor, num_pts = points_2d.shape[1:3]
    return plan_dfa(bs, cams, num_anchor, num_pts, weights.shape[-1], c,
                    gather_capacity, spatial_shapes.shapes)


def _dfa_launch(col_feats, spatial_shapes, points_2d, weights,
                gather_capacity):
    """Kernel launch of the forward -> (out, the rank pass's count
    thresholds or None)."""
    what = "deformable_aggregation"
    plan = _dfa_plan(col_feats, spatial_shapes, points_2d, weights,
                     gather_capacity)
    _check_aligned(what, col_feats, "col_feats")
    dev = col_feats.device
    bs, _, _, c = col_feats.shape
    scratch = (torch.empty(plan.scratch, dtype=torch.int32, device=dev)
               if plan.scratch else None)
    out = torch.empty((bs, points_2d.shape[1], c), dtype=torch.float32,
                      device=dev)
    _kernels.check(_kernels.load("sampling").simpb_dfa(
        *map(_kernels.ptr, (col_feats, points_2d, weights, scratch, out)),
        plan.dims, _stride_array(points_2d.stride() + weights.stride()),
        _kernels.DTYPE_CODE[col_feats.dtype],
        ctypes.c_void_p(_kernels.stream_ptr(col_feats))), what)
    _LAUNCHES["deformable_aggregation"] += 1
    return out, scratch


B2_TILE = 8  # B2's pixel tile side (csrc/sampling.cu)


def _tile_plan(shapes):
    """B2_TILE x B2_TILE pixel tiles of the levels, numbered smallest
    level first (the crowded tiles start first): (count, first tile of
    each level)."""
    counts = [-(-h // B2_TILE) * -(-w // B2_TILE) for h, w in shapes]
    first, tiles = [0] * len(shapes), 0
    for lvl in sorted(range(len(shapes)),
                      key=lambda i: shapes[i][0] * shapes[i][1]):
        first[lvl], tiles = tiles, tiles + counts[lvl]
    return tiles, first


class DfaBwdPlan(NamedTuple):
    """Kernel B's three launches. B0: one block per camera row. B1: one
    block per (anchor, batch), `grid` (anchors, bs), `threads` and `smem`
    bytes a block. B2: `gcol_grid` (camera rows, B2_TILE x B2_TILE pixel
    tiles of all levels). `scratch`: the int32 words of B1's records and
    B0's counts. `dims`: the host int array the C entry reads."""
    grid: Tuple[int, int]
    threads: int
    smem: int
    gcol_grid: Tuple[int, int]
    scratch: int
    dims: ctypes.Array


@functools.lru_cache(maxsize=None)
def plan_dfa_backward(bs: int, cams: int, num_anchor: int, num_pts: int,
                      num_groups: int, c: int, gather_capacity: Optional[int],
                      shapes: Tuple[Tuple[int, int], ...]) -> DfaBwdPlan:
    """Kernel B's launches: B1 one block per (anchor, batch) of teams of
    C / 8 threads (C / 8 a power of two up to 32, and so C / G / 8), the
    live entries' corner data and weights in shared memory; B2 one block
    per (camera row, 8x8 tile), the tiles numbered smallest level first
    so that the crowded ones start first. Raises ValueError on a shape
    the kernels do not take."""
    what = "deformable_aggregation_backward"
    fwd = plan_dfa(bs, cams, num_anchor, num_pts, num_groups, c,
                   gather_capacity, shapes)
    ch = c // 8
    gsz = ch // num_groups
    if ch > 32 or ch & (ch - 1) or gsz & (gsz - 1):
        raise ValueError(f"{what}: C / 8 = {ch} and C / G / 8 = {gsz} must "
                         "be powers of two, C / 8 at most 32")
    if any(max(h, w) > MAX_LEVEL_SIDE for h, w in shapes):
        raise ValueError(f"{what}: levels {shapes} exceed "
                         f"{MAX_LEVEL_SIDE} pixels a side")
    threads = max(32, (DFA_THREADS // ch) * ch)
    entries = cams * num_pts * len(shapes)
    smem = entries * (56 + 4 * num_groups) + 4 * cams * (num_pts + 1)
    if smem > _kernels.MAX_SMEM:
        raise ValueError(f"{what}: {entries} samples per anchor do not fit "
                         "in shared memory")
    tiles, first = _tile_plan(shapes)
    rows = bs * cams
    cap = fwd.dims[8]
    per_row = cap if cap >= 0 else num_anchor * num_pts
    scratch = rows * (len(shapes) * per_row * (5 + num_groups) + per_row
                      + num_anchor + 1)
    dims = list(fwd.dims)
    dims[9], dims[10] = threads, smem
    return DfaBwdPlan((num_anchor, bs), threads, smem, (rows, tiles),
                      scratch, _kernels.int_array(dims + [tiles] + first))


def _dfa_bwd_buffers(col_feats, points_2d, weights, plan):
    """Kernel B's outputs (gcol, gpts, gwts, each in its input's dtype and
    written whole by the kernels) and its int32 scratch."""
    dev = col_feats.device
    empty = lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev)
    return (empty(col_feats), empty(points_2d), empty(weights),
            torch.empty(plan.scratch, dtype=torch.int32, device=dev))


def _dfa_bwd_launch(col_feats, points_2d, weights, thresholds, gout, plan,
                    buffers, stages=7):
    """Launch kernel B's stages (1 B0, 2 B1, 4 B2) into `buffers`."""
    _kernels.check(_kernels.load("sampling").simpb_dfa_bwd(
        *map(_kernels.ptr, (col_feats, points_2d, weights, thresholds, gout)
             + tuple(buffers)),
        plan.dims, _stride_array(points_2d.stride() + weights.stride()),
        _kernels.DTYPE_CODE[col_feats.dtype], stages,
        ctypes.c_void_p(_kernels.stream_ptr(col_feats))),
        "deformable_aggregation_backward")


def deformable_aggregation_backward(
    col_feats: torch.Tensor, spatial_shapes: SpatialShapes,
    points_2d: torch.Tensor, weights: torch.Tensor,
    grad_out: torch.Tensor, gather_capacity: Optional[int] = None,
    thresholds: Optional[torch.Tensor] = None,
):
    """Kernel B: the gradients (col_feats, points_2d, weights), each in
    its input's dtype, of `deformable_aggregation` at grad_out [bs, A, C].
    `thresholds` is the forward's saved capacity compaction (None when
    the capacity does not bite). CUDA tensors only. Deterministic: no
    atomics, so a repeat call gives the same bits."""
    what = "deformable_aggregation_backward"
    _check_dfa(col_feats, spatial_shapes, points_2d, weights)
    if col_feats.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors")
    bs, cams, total_hw, c = col_feats.shape
    num_anchor, num_pts = points_2d.shape[1:3]
    plan = plan_dfa_backward(bs, cams, num_anchor, num_pts, weights.shape[-1],
                             c, gather_capacity, spatial_shapes.shapes)
    if (thresholds is None) != (plan.dims[8] < 0):
        raise ValueError(f"{what}: the forward's thresholds are needed "
                         "exactly when the capacity bites")
    _check_aligned(what, col_feats, "col_feats")
    buffers = _dfa_bwd_buffers(col_feats, points_2d, weights, plan)
    _dfa_bwd_launch(col_feats, points_2d, weights, thresholds,
                    grad_out.float().contiguous(), plan, buffers)
    _LAUNCHES["deformable_aggregation_backward"] += 1
    return buffers[:3]


def deformable_aggregation_backward_plain(
    col_feats, spatial_shapes, points_2d, weights, grad_out,
    gather_capacity=None,
):
    """Kernel B's plain version: the gradients (col_feats, points_2d,
    weights) of `deformable_aggregation_plain` at grad_out [bs, A, C],
    each an fp32 sum over the forward's rounded quantities (corner
    weights, samples, in the storage type), rounded once to its input's
    dtype. Slots the capacity drops and samples out of range get zero."""
    bs, cams, total_hw, c = col_feats.shape
    num_anchor, num_pts = points_2d.shape[1:3]
    num_levels, num_groups = weights.shape[-2:]
    gd = c // num_groups
    b = bs * cams
    dev = col_feats.device
    dt = col_feats.dtype
    loc, w_all, sel_valid, slot = dfa_slots(points_2d, weights,
                                            gather_capacity)
    anchor_idx = slot // num_pts
    m = loc.shape[1]
    table = col_feats.reshape(b * total_hw, c)
    batch_base = (torch.arange(b, device=dev) * total_hw)[:, None]
    go = grad_out.float().reshape(bs, 1, num_anchor, c).expand(
        bs, cams, num_anchor, c).reshape(b, num_anchor, c)
    go = torch.gather(go, 1, anchor_idx[..., None].expand(b, m, c))
    go = go * sel_valid[..., None].float()  # [b, m, C] fp32
    gcol = torch.zeros((b * total_hw, c), dtype=torch.float32, device=dev)
    gloc = torch.zeros((b, m, 2), dtype=torch.float32, device=dev)
    gw = torch.zeros((b, m, num_levels, num_groups), dtype=torch.float32,
                     device=dev)
    e = lambda t: t.float()[..., None]
    for lvl in range(num_levels):
        h_, w_ = spatial_shapes.shapes[lvl]
        base = batch_base + spatial_shapes.start_indices[lvl]
        sampled, wx0, wx1, wy0, wy1 = _sample_rows(table, base, h_, w_, loc,
                                                   True)
        _, _, _, _, x0, y0, y1 = _corner_weights(loc, h_, w_, dt, True)
        mx0 = e((x0 >= 0) & (x0 < w_))
        mx1 = e((x0 + 1 >= 0) & (x0 + 1 < w_))
        my0 = e((y0 >= 0) & (y0 < h_))
        my1 = e((y1 >= 0) & (y1 < h_))
        r0 = base + y0.clamp(0, h_ - 1) * w_
        r1 = base + y1.clamp(0, h_ - 1) * w_
        xc0, xc1 = x0.clamp(0, w_ - 1), (x0 + 1).clamp(0, w_ - 1)
        rows = (r0 + xc0, r0 + xc1, r1 + xc0, r1 + xc1)
        v00, v01, v10, v11 = (_take_rows(table, r).float() for r in rows)
        gw_l = w_all[:, :, lvl].float()  # [b, m, G]
        gw[:, :, lvl] = (go * sampled.float()).reshape(
            b, m, num_groups, gd).sum(-1)
        gs = go * gw_l[..., None].expand(b, m, num_groups, gd).reshape(
            b, m, c)
        for r, wk in zip(rows, (e(wy0) * e(wx0), e(wy0) * e(wx1),
                                e(wy1) * e(wx0), e(wy1) * e(wx1))):
            gcol.index_add_(0, r.clamp(0, table.shape[0] - 1).reshape(-1),
                            (gs * wk).reshape(-1, c))
        vx0 = e(wx0) * v00 + e(wx1) * v01
        vx1 = e(wx0) * v10 + e(wx1) * v11
        dlx = e(wy0) * (mx1 * v01 - mx0 * v00) + e(wy1) * (mx1 * v11
                                                          - mx0 * v10)
        dly = my1 * vx1 - my0 * vx0
        gloc[..., 0] += (gs * dlx).sum(-1) * w_
        gloc[..., 1] += (gs * dly).sum(-1) * h_
    # scatter the slots back onto (anchor, point)
    gpts = torch.zeros((b, num_anchor * num_pts, 2), dtype=torch.float32,
                       device=dev)
    gpts.scatter_(1, slot[..., None].expand(b, m, 2), gloc)
    gwts = torch.zeros((b, num_anchor * num_pts, num_levels, num_groups),
                       dtype=torch.float32, device=dev)
    gwts.scatter_(1, slot[..., None, None].expand(gw.shape), gw)
    gpts = gpts.reshape(bs, cams, num_anchor, num_pts, 2).permute(
        0, 2, 3, 1, 4)
    gwts = gwts.reshape(bs, cams, num_anchor, num_pts, num_levels,
                        num_groups).permute(0, 2, 3, 1, 4, 5)
    return (gcol.reshape(col_feats.shape).to(dt), gpts.to(points_2d.dtype),
            gwts.to(weights.dtype))


class _DfaPlainFunction(torch.autograd.Function):
    """The CPU path: the plain forward, and kernel B's plain version as
    its backward."""

    @staticmethod
    def forward(ctx, col_feats, points_2d, weights, spatial_shapes,
                gather_capacity):
        ctx.save_for_backward(col_feats, points_2d, weights)
        ctx.args = (spatial_shapes, gather_capacity)
        return deformable_aggregation_plain(col_feats, spatial_shapes,
                                            points_2d, weights,
                                            gather_capacity)

    @staticmethod
    def backward(ctx, grad_out):
        col_feats, points_2d, weights = ctx.saved_tensors
        ss, cap = ctx.args
        return deformable_aggregation_backward_plain(
            col_feats, ss, points_2d, weights, grad_out, cap) + (None, None)


class _DfaFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, col_feats, points_2d, weights, spatial_shapes,
                gather_capacity):
        out, thresholds = _dfa_launch(col_feats, spatial_shapes, points_2d,
                                      weights, gather_capacity)
        ctx.save_for_backward(col_feats, points_2d, weights, thresholds)
        ctx.spatial_shapes = spatial_shapes
        ctx.gather_capacity = gather_capacity
        return out

    @staticmethod
    def backward(ctx, grad_out):
        col_feats, points_2d, weights, thresholds = ctx.saved_tensors
        grads = deformable_aggregation_backward(
            col_feats, ctx.spatial_shapes, points_2d, weights, grad_out,
            ctx.gather_capacity, thresholds)
        return grads + (None, None)


def deformable_aggregation(
    col_feats: torch.Tensor,  # [bs, cams, ΣHW, C]
    spatial_shapes: SpatialShapes,
    points_2d: torch.Tensor,  # [bs, A, P, cams, 2]
    weights: torch.Tensor,  # [bs, A, P, cams, L, G]
    gather_capacity: Optional[int] = None,
) -> torch.Tensor:
    """Fused multi-camera multi-scale deformable aggregation ->
    [bs, A, C] float32 (see `deformable_aggregation_plain`),
    differentiable in all three tensors.

    Points and weights share the features' dtype (float32 or bfloat16)
    and may have any strides; the features must be contiguous (on the
    card 16-byte aligned, with C/G a multiple of 8)."""
    _check_dfa(col_feats, spatial_shapes, points_2d, weights)
    if col_feats.device.type == "cpu":
        return _DfaPlainFunction.apply(col_feats, points_2d, weights,
                                       spatial_shapes, gather_capacity)
    return _DfaFunction.apply(col_feats, points_2d, weights, spatial_shapes,
                              gather_capacity)


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 `x` rounded to `dtype` and widened back; its gradient passes
    unchanged, as through a cast, and stays fp32."""
    if dtype == torch.float32:
        return x
    return x + (x.to(dtype).float() - x).detach()


def _msda_level(table, base, h, w, loc, dtype):
    """One level of exact MSDA read from the fp32 [R, C] table: (samples
    [B, N, C], in-image bilinear mass [B, N]), fp32 holding what the
    value's type computes (JAX's order: the corner weights, the x pairs
    and the y combine each rounded to `dtype`, the mass the fp32 product
    of the rounded weight sums). Border corners weigh zero and have no
    location gradient; indices are clamped into the level."""
    r = lambda t: _round_to(t, dtype)
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    lx, ly = r(x - x0f), r(y - y0f)
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    inside = lambda i, n: ((i >= 0) & (i < n)).float()
    wx0 = r(1.0 - lx) * inside(x0, w)
    wx1 = lx * inside(x0 + 1, w)
    wy0 = r(1.0 - ly) * inside(y0, h)
    wy1 = ly * inside(y0 + 1, h)
    xc0, xc1 = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    r0 = base + y0.clamp(0, h - 1) * w
    r1 = base + (y0 + 1).clamp(0, h - 1) * w
    take = lambda rows: _take_rows(table, rows)
    e = lambda t: t[..., None]
    vx0 = r(r(e(wx0) * take(r0 + xc0)) + r(e(wx1) * take(r0 + xc1)))
    vx1 = r(r(e(wx0) * take(r1 + xc0)) + r(e(wx1) * take(r1 + xc1)))
    sample = r(r(e(wy0) * vx0) + r(e(wy1) * vx1))
    return sample, r(wx0 + wx1) * r(wy0 + wy1)


def msda_plain(
    value: torch.Tensor,  # [B, ΣHW, C]
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,  # [B, Q, heads, L, P, 2]
    attention_weights: torch.Tensor,  # [B, Q, heads, L, P]
    raw_heads: bool = False,
):
    """Exact multi-scale deformable attention, plain PyTorch: every
    sample reads its level bilinearly (border corners weigh zero, samples
    outside (0, 1) are kept; a padded slot's location 0 samples pixel
    (0, 0) with a quarter of its attention). In JAX's rounding order: the
    corner weights and the x-then-y combine in the value's type, the
    attention weighting in fp32. Computed in fp32 with each rounding to
    the value's type written out, so that autograd through it sums every
    gradient in fp32 and rounds the value gradient once, to the value's
    type.

    raw_heads: (sampled [B, Q, heads, C], wsum [B, Q, heads]) before the
    per-head channel split, wsum the attention times the in-image
    bilinear mass (wx0 + wx1)(wy0 + wy1); otherwise [B, Q, C] float32."""
    b, total_hw, c = value.shape
    q, heads, num_levels, num_points = sampling_locations.shape[1:5]
    dev = value.device
    table = value.reshape(b * total_hw, c).float()
    batch_base = (torch.arange(b, device=dev) * total_hw)[:, None]
    acc = torch.zeros((b, q, heads, c), dtype=torch.float32, device=dev)
    acc_w = torch.zeros((b, q, heads), dtype=torch.float32, device=dev)
    for lvl in range(num_levels):
        h_, w_ = spatial_shapes.shapes[lvl]
        start = spatial_shapes.start_indices[lvl]
        loc = sampling_locations[:, :, :, lvl].reshape(b, -1, 2)
        sampled, mass = _msda_level(table, batch_base + start, h_, w_, loc,
                                    value.dtype)
        w_l = attention_weights[:, :, :, lvl].float()  # [B, Q, heads, P]
        acc = acc + torch.einsum(
            "bqhpc,bqhp->bqhc", sampled.reshape(b, q, heads, num_points, c),
            w_l)
        acc_w = acc_w + torch.einsum(
            "bqhp,bqhp->bqh", w_l, mass.reshape(b, q, heads, num_points))
    if raw_heads:
        return acc, acc_w
    head_mask = torch.repeat_interleave(
        torch.eye(heads, device=dev), c // heads, dim=1)
    return torch.einsum("bqhc,hc->bqc", acc, head_mask)


MSDA_HEADS = 8  # heads of an exact-MSDA block, a warp each


@functools.lru_cache(maxsize=None)
def plan_msda(num_rows: int, num_queries: int, heads: int, num_points: int,
              c: int, shapes: Tuple[Tuple[int, int], ...]) -> SamplingPlan:
    """The exact MSDA kernel's launch for [num_rows, ΣHW, c] values over
    the levels `shapes`: one block per (camera row, query), a warp per
    head, a lane 8 channels. Raises ValueError on a shape the kernel does
    not take: more than MSDA_HEADS heads, C not a multiple of 8, more
    than MAX_LEVELS levels, no query."""
    what = "msda"
    num_levels = len(shapes)
    if (not 0 < heads <= MSDA_HEADS or c % 8 or not c
            or not 0 < num_levels <= MAX_LEVELS or num_points < 1
            or num_rows * num_queries < 1):
        raise ValueError(f"{what}: the kernel takes 1 to {MSDA_HEADS} heads, "
                         "C a multiple of 8, 1 to "
                         f"{MAX_LEVELS} levels and at least one query, got "
                         f"{heads} heads, C = {c}, {num_levels} levels, "
                         f"{num_rows} x {num_queries} queries")
    threads = 32 * heads
    dims = [num_rows, num_queries, heads, num_levels, num_points, c,
            sum(h * w for h, w in shapes), threads]
    return SamplingPlan((num_rows * num_queries, 1), threads, 0, 0,
                        _kernels.int_array(dims + _level_table(shapes)))


def _check_msda(value, spatial_shapes, sampling_locations,
                attention_weights):
    what = "msda"
    _check_devices(what, value, sampling_locations, attention_weights)
    _check_storage(what, value, "value")
    for name, t in (("sampling_locations", sampling_locations),
                    ("attention_weights", attention_weights)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    b, total_hw, _ = value.shape
    q = sampling_locations.shape[1]
    if (sampling_locations.dim() != 6 or sampling_locations.shape[0] != b
            or sampling_locations.shape[-1] != 2
            or sampling_locations.shape[3] != spatial_shapes.num_levels
            or tuple(attention_weights.shape)
            != tuple(sampling_locations.shape[:5])):
        raise ValueError(f"{what}: shapes {tuple(value.shape)}, "
                         f"{tuple(sampling_locations.shape)}, "
                         f"{tuple(attention_weights.shape)} do not fit "
                         f"together over {spatial_shapes.num_levels} levels "
                         f"({q} queries)")
    _check_levels(what, spatial_shapes, total_hw)


def _msda_launch(value, spatial_shapes, sampling_locations,
                 attention_weights):
    what = "msda"
    b, _, c = value.shape
    q, heads, _, num_points = sampling_locations.shape[1:5]
    plan = plan_msda(b, q, heads, num_points, c, spatial_shapes.shapes)
    _check_aligned(what, value, "value")
    dev = value.device
    sampled = torch.empty((b, q, heads, c), dtype=torch.float32, device=dev)
    wsum = torch.empty((b, q, heads), dtype=torch.float32, device=dev)
    _kernels.check(_kernels.load("sampling").simpb_msda(
        *map(_kernels.ptr, (value, sampling_locations, attention_weights,
                            sampled, wsum)), plan.dims,
        _kernels.DTYPE_CODE[value.dtype],
        ctypes.c_void_p(_kernels.stream_ptr(value))), what)
    _LAUNCHES["msda"] += 1
    return sampled, wsum


class _MsdaFunction(torch.autograd.Function):
    """Exact MSDA on the card: the forward kernel, and kernel D as its
    backward. Saves only its inputs: D recomputes the samples (what
    `jax.checkpoint` does around JAX's op)."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights,
                spatial_shapes):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        return _msda_launch(value, spatial_shapes, sampling_locations,
                            attention_weights)

    @staticmethod
    def backward(ctx, grad_sampled, grad_wsum):
        value, loc, attw = ctx.saved_tensors
        return msda_backward(value, ctx.spatial_shapes, loc, attw,
                             grad_sampled, grad_wsum) + (None,)


def msda(
    value: torch.Tensor,  # [B, ΣHW, C]
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,  # [B, Q, heads, L, P, 2]
    attention_weights: torch.Tensor,  # [B, Q, heads, L, P]
    raw_heads: bool = False,
):
    """Exact multi-scale deformable attention (see `msda_plain`):
    (sampled [B, Q, heads, C], wsum [B, Q, heads]) float32 with
    `raw_heads`, else [B, Q, C] float32 (the per-head channel split in
    torch around the op), differentiable in all three tensors. Value
    float32 or bfloat16, contiguous (16-byte aligned on the card);
    locations and weights float32, contiguous. On the CPU the plain
    version (under autograd when asked); on the card the forward kernel,
    with kernel D (`msda_backward`) as its backward."""
    _check_msda(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type == "cpu":
        return msda_plain(value, spatial_shapes, sampling_locations,
                          attention_weights, raw_heads)
    sampled, wsum = _MsdaFunction.apply(value, sampling_locations,
                                        attention_weights, spatial_shapes)
    if raw_heads:
        return sampled, wsum
    heads, c = sampled.shape[2:]
    head_mask = torch.repeat_interleave(
        torch.eye(heads, device=value.device), c // heads, dim=1)
    return torch.einsum("bqhc,hc->bqc", sampled, head_mask)


def _window_base(px, py, keep, ph, pw, hlim, wlim):
    """Midrange-centred window base (int64) for patch-mode sampling;
    dropped (zero-weight) samples do not drag the window, and a query
    with every sample dropped falls back to mid 0."""
    kb = keep > 0.0
    big = torch.tensor(1e9, dtype=torch.float32, device=px.device)
    mid_x = 0.5 * (
        torch.where(kb, px, big).amin(-1) + torch.where(kb, px, -big).amax(-1)
    )
    mid_y = 0.5 * (
        torch.where(kb, py, big).amin(-1) + torch.where(kb, py, -big).amax(-1)
    )
    base_x = torch.round(mid_x - (pw - 1) / 2.0).to(torch.int64)
    base_y = torch.round(mid_y - (ph - 1) / 2.0).to(torch.int64)
    # clip(v, 0, hi) == min(max(v, 0), hi), as jnp.clip (hi may be < 0)
    base_x = torch.minimum(base_x.clamp(min=0),
                           torch.as_tensor(wlim - pw, device=px.device))
    base_y = torch.minimum(base_y.clamp(min=0),
                           torch.as_tensor(hlim - ph, device=px.device))
    return base_x, base_y


def shrink_patch(patch_h: int, patch_w: int, h: int, w: int):
    """Per-level window: never larger than the level, width kept even."""
    ph = min(patch_h, h)
    pw = min(patch_w, w)
    pw = max(2, pw - (pw % 2))
    return ph, pw


def _window_weights(px, py, keep, a, base_x, base_y, ph, pw):
    """Separable one-hot bilinear weights over the window, times the
    attention: [..., n, ph*pw]. Samples are taper-clamped into
    [base-1, base+p] so corners keep their true positions and samples
    reaching beyond the window fade out."""
    bx = base_x[..., None]
    by = base_y[..., None]
    ax = torch.maximum(torch.minimum(px, bx + pw - 1e-4), bx - 1 + 1e-4)
    ay = torch.maximum(torch.minimum(py, by + ph - 1e-4), by - 1 + 1e-4)
    x0 = torch.floor(ax)
    y0 = torch.floor(ay)
    lx = ax - x0
    ly = ay - y0
    i0x = x0.to(torch.int64) - bx
    i0y = y0.to(torch.int64) - by
    whx = (1.0 - lx)[..., None] * one_hot(i0x, pw) + lx[..., None] * one_hot(
        i0x + 1, pw
    )
    why = (1.0 - ly)[..., None] * one_hot(i0y, ph) + ly[..., None] * one_hot(
        i0y + 1, ph
    )
    wpix = (why[..., :, None] * whx[..., None, :]).flatten(-2)
    return wpix * (a * keep)[..., None]


def msda_patch(
    value: torch.Tensor,  # [B, ΣHW, C]
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,  # [B, Q, heads, L, P, 2]
    attention_weights: torch.Tensor,  # [B, Q, heads, L, P]
    patch_h: int = 8,
    patch_w: int = 8,
    sel_levels: Optional[int] = None,
    raw_heads: bool = False,
):
    """Windowed multi-scale deformable attention.

    Every sample of a (query, level) is served from one patch_h x
    patch_w window placed at the samples' midrange. With `sel_levels`
    and a patch that fits every level, each query samples only its
    `sel_levels` highest-attention-mass levels (`_msda_patch_sel`);
    otherwise every level, with the window shrunk to small levels.

    raw_heads: return (sampled [B, Q, heads, C], wsum [B, Q, heads])
    before the per-head channel split, where wsum is each head's
    total effective sampling weight; otherwise [B, Q, C] float32.
    """
    b, total_hw, c = value.shape
    q = sampling_locations.shape[1]
    heads, num_levels, num_points = sampling_locations.shape[2:5]
    n = heads * num_points
    dev = value.device
    loc = sampling_locations.permute(0, 1, 3, 2, 4, 5).reshape(
        b, q, num_levels, n, 2
    )
    attw = attention_weights.permute(0, 1, 3, 2, 4).reshape(
        b, q, num_levels, n
    )
    patch_fits_all = all(
        h_ >= patch_h and w_ >= patch_w and patch_w % 2 == 0
        for h_, w_ in spatial_shapes.shapes
    )
    if sel_levels is not None and sel_levels < num_levels and patch_fits_all:
        acc, acc_w = _msda_patch_sel(
            value, spatial_shapes, loc, attw, heads, patch_h, patch_w,
            sel_levels,
        )
    else:
        table = value.reshape(b * total_hw, c)
        batch_base = (torch.arange(b, device=dev) * total_hw)[:, None]
        acc = torch.zeros((b, q, heads, c), dtype=torch.float32, device=dev)
        acc_w = torch.zeros((b, q, heads), dtype=torch.float32, device=dev)
        for lvl in range(num_levels):
            h_, w_ = spatial_shapes.shapes[lvl]
            start = spatial_shapes.start_indices[lvl]
            ph, pw = shrink_patch(patch_h, patch_w, h_, w_)
            l = loc[:, :, lvl]
            px = l[..., 0] * w_ - 0.5
            py = l[..., 1] * h_ - 0.5
            keep = ((px > -1.0) & (px < w_) & (py > -1.0)
                    & (py < h_)).float()
            base_x, base_y = _window_base(px, py, keep, ph, pw, h_, w_)
            dy = torch.arange(ph, device=dev)
            dx = torch.arange(pw, device=dev)
            rows = (
                batch_base[:, :, None, None] + start
                + (base_y[:, :, None, None] + dy[:, None]) * w_
                + base_x[:, :, None, None] + dx
            )  # [B, Q, ph, pw]
            patch = _take_rows(table, rows).reshape(b, q, ph * pw, c)
            wpix = _window_weights(
                px, py, keep, attw[:, :, lvl].float(), base_x, base_y, ph, pw
            )  # [B, Q, n, ph*pw]
            wpix = wpix.reshape(b, q, heads, num_points, ph * pw).sum(3)
            acc = acc + torch.einsum("bqhe,bqec->bqhc", wpix, patch.float())
            acc_w = acc_w + wpix.sum(-1)
    if raw_heads:
        return acc, acc_w
    head_mask = torch.repeat_interleave(
        torch.eye(heads, device=dev), c // heads, dim=1
    )
    return torch.einsum("bqhc,hc->bqc", acc, head_mask)


def _lost_weights(spatial_shapes: SpatialShapes, loc: torch.Tensor,
                  patch_h: int, patch_w: int):
    """Per sample of loc [B, Q, L, n, 2] (head-major samples), the
    bilinear weight its lost corners carry: corners inside the image but
    outside the window `msda_patch` places (`_window_base`,
    `shrink_patch`). Returns (lost_w, keep), both [B, Q, L, n] float32,
    `keep` the in-image support mask."""
    lost_all, keep_all = [], []
    for lvl, (h_, w_) in enumerate(spatial_shapes.shapes):
        ph, pw = shrink_patch(patch_h, patch_w, h_, w_)
        l = loc[:, :, lvl].float()
        px = l[..., 0] * w_ - 0.5
        py = l[..., 1] * h_ - 0.5
        keep = ((px > -1.0) & (px < w_) & (py > -1.0)
                & (py < h_)).float()
        base_x, base_y = _window_base(px, py, keep, ph, pw, h_, w_)
        x0 = torch.floor(px).to(torch.int64)
        y0 = torch.floor(py).to(torch.int64)
        bx, by = base_x[..., None], base_y[..., None]
        fx = px - x0.float()
        fy = py - y0.float()
        lost_w = torch.zeros_like(px)
        for cx, wx_ in ((x0, 1.0 - fx), (x0 + 1, fx)):
            in_x = (cx >= 0) & (cx <= w_ - 1)
            out_x = (cx < bx) | (cx > bx + pw - 1)
            for cy, wy_ in ((y0, 1.0 - fy), (y0 + 1, fy)):
                in_y = (cy >= 0) & (cy <= h_ - 1)
                out_y = (cy < by) | (cy > by + ph - 1)
                lost_c = in_x & in_y & (out_x | out_y)
                lost_w = lost_w + lost_c.float() * wx_ * wy_
        lost_all.append(lost_w * keep)
        keep_all.append(keep)
    return torch.stack(lost_all, dim=2), torch.stack(keep_all, dim=2)


def msda_window_stats(
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,  # [B, Q, heads, L, P, 2]
    attention_weights: torch.Tensor,  # [B, Q, heads, L, P]
    patch_h: int,
    patch_w: int,
    sel_levels: Optional[int] = None,
    valid: Optional[torch.Tensor] = None,  # [B, Q] bool
):
    """The exactness guard of windowed MSDA (window and level selection),
    per batch row: `window_clamped`, the weight-bearing samples whose
    bilinear stencil the window does not serve whole; `window_clamped_mass`,
    their attention mass times the lost corners' bilinear weight;
    `level_dropped_mass`, the largest attention mass of a query on the
    levels it does not sample (0 without `sel_levels`). Slots outside
    `valid` count nothing. Plain PyTorch on every device: it reads
    locations and weights, not feature rows."""
    b, q = sampling_locations.shape[:2]
    heads, num_levels, num_points = sampling_locations.shape[2:5]
    n = heads * num_points
    dev = sampling_locations.device
    loc = sampling_locations.permute(0, 1, 3, 2, 4, 5).reshape(
        b, q, num_levels, n, 2)
    attw = attention_weights.permute(0, 1, 3, 2, 4).reshape(
        b, q, num_levels, n).float()
    vmask = (torch.ones((b, q), dtype=torch.float32, device=dev)
             if valid is None else valid.float())
    patch_fits_all = all(
        h_ >= patch_h and w_ >= patch_w and patch_w % 2 == 0
        for h_, w_ in spatial_shapes.shapes
    )
    if sel_levels is not None and sel_levels < num_levels and patch_fits_all:
        mass = attw.sum(-1)  # [B, Q, L]
        _, lsel = topk_stable(mass, sel_levels)
        sel_mask = one_hot(lsel, num_levels).sum(2)  # [B, Q, L]
        dropped = ((mass * (1.0 - sel_mask)).sum(-1) * vmask).amax(-1)
    else:
        sel_mask = torch.ones((b, q, num_levels), dtype=torch.float32,
                              device=dev)
        dropped = torch.zeros((b,), dtype=torch.float32, device=dev)
    lost_w, _ = _lost_weights(spatial_shapes, loc, patch_h, patch_w)
    gate = vmask[:, :, None, None] * sel_mask[:, :, :, None]
    inexact = (lost_w > 0).float() * gate
    return {
        "window_clamped": inexact.sum((1, 2, 3)),
        "window_clamped_mass": (lost_w * gate * attw).sum((1, 2, 3)),
        "level_dropped_mass": dropped,
    }


def msda_sel_windows(
    total_hw: int,
    spatial_shapes: SpatialShapes,
    loc: torch.Tensor,  # [B, Q, L, n, 2]
    attw: torch.Tensor,  # [B, Q, L, n]
    patch_h: int,
    patch_w: int,
    sel_levels: int,
):
    """Where `_msda_patch_sel` samples: each query's top-`sel_levels`
    levels by attention mass and their windows. Returns (rows [B, Q, k,
    ph, pw] of the flat [B * ΣHW] value table, px, py, keep, a_s
    [B, Q, k, n], base_x, base_y [B, Q, k])."""
    b, q, num_levels, n = loc.shape[:4]
    k = sel_levels
    ph, pw = patch_h, patch_w
    dev = loc.device
    h_vec = torch.tensor([h_ for h_, _ in spatial_shapes.shapes], device=dev)
    w_vec = torch.tensor([w_ for _, w_ in spatial_shapes.shapes], device=dev)
    start_vec = torch.tensor(spatial_shapes.start_indices, device=dev)

    mass = attw.float().sum(-1)  # [B, Q, L]
    _, lsel = topk_stable(mass, k)  # [B, Q, k]
    loc_s = torch.gather(
        loc.float(), 2, lsel[..., None, None].expand(b, q, k, n, 2)
    )
    a_s = torch.gather(attw.float(), 2, lsel[..., None].expand(b, q, k, n))
    hh, ww, st = h_vec[lsel], w_vec[lsel], start_vec[lsel]  # [B, Q, k]
    wwf = ww.float()[..., None]
    hhf = hh.float()[..., None]
    px = loc_s[..., 0] * wwf - 0.5  # [B, Q, k, n]
    py = loc_s[..., 1] * hhf - 0.5
    keep = ((px > -1.0) & (px < wwf) & (py > -1.0) & (py < hhf)).float()
    base_x, base_y = _window_base(px, py, keep, ph, pw, hh, ww)

    batch_base = (torch.arange(b, device=dev) * total_hw)[
        :, None, None, None, None
    ]
    dy = torch.arange(ph, device=dev)[:, None]
    dx = torch.arange(pw, device=dev)[None, :]
    rows = (
        batch_base + st[..., None, None]
        + (base_y[..., None, None] + dy) * ww[..., None, None]
        + base_x[..., None, None] + dx
    )  # [B, Q, k, ph, pw]
    return rows, px, py, keep, a_s, base_x, base_y


def _msda_patch_sel_plain(
    value: torch.Tensor,  # [B, ΣHW, C]
    spatial_shapes: SpatialShapes,
    loc: torch.Tensor,  # [B, Q, L, n, 2] (head-major samples)
    attw: torch.Tensor,  # [B, Q, L, n]
    heads: int,
    patch_h: int,
    patch_w: int,
    sel_levels: int,
):
    """`msda_patch` at each query's top-`sel_levels` levels by attention
    mass, plain PyTorch; per-level constants come from small lookup
    vectors. Returns (sampled [B, Q, heads, C], wsum [B, Q, heads]),
    float32."""
    b, total_hw, c = value.shape
    q, n = loc.shape[1], loc.shape[3]
    num_points = n // heads
    k = sel_levels
    ph, pw = patch_h, patch_w
    rows, px, py, keep, a_s, base_x, base_y = msda_sel_windows(
        total_hw, spatial_shapes, loc, attw, ph, pw, k)
    # the table in fp32 (exact): the same samples, and a value gradient
    # summed in fp32 and rounded once
    patch = _take_rows(value.float().reshape(b * total_hw, c), rows).reshape(
        b, q, k, ph * pw, c
    )
    wpix = _window_weights(px, py, keep, a_s, base_x, base_y, ph, pw)
    wpix = wpix.reshape(b, q, k, heads, num_points, ph * pw).sum(4)
    weighted = torch.einsum("bqkhe,bqkec->bqhc", wpix, patch.float())
    return weighted, wpix.sum(-1).sum(2)


def _msda_tc_smem(num_levels: int, n: int, c: int) -> int:
    """Shared memory of an MSDA-sel tensor-core block (csrc/sampling.cu
    `MsdaSmem`): the windows' 128 pixel rows (C bf16), the weights' three
    bf16 parts (8 rows each, and a zero row, of 136), then the query's
    locations, weights, levels and window bases."""
    kw = MSDA_TC_SHAPE[0] * MSDA_TC_SHAPE[1] * MSDA_TC_SHAPE[2]
    return (kw * c * 2 + 25 * (kw + 8) * 2
            + 4 * (3 * num_levels * n + 3 * MSDA_TC_SHAPE[0]))


@functools.lru_cache(maxsize=None)
def plan_msda_sel(num_rows: int, num_queries: int, n: int, heads: int,
                  c: int, k: int, ph: int, pw: int, dtype: torch.dtype,
                  shapes: Tuple[Tuple[int, int], ...]) -> SamplingPlan:
    """MSDA-sel's launch for [num_rows, ΣHW, c] values over the levels
    `shapes`, num_queries queries a row with n samples (heads x points)
    a level, the top `k` levels and a ph x pw window: fp32 one block per
    (query, camera row); bf16 (tensor cores) one block per query, three
    an SM at the main shapes. Raises ValueError on a shape the kernels do
    not take."""
    what = "_msda_patch_sel"
    num_levels = len(shapes)
    win = ph * pw
    if (num_levels > MAX_LEVELS or heads > MAX_HEADS or n % heads
            or not 0 < k <= num_levels or pw % 2):
        raise ValueError(f"{what}: {heads} heads (at most {MAX_HEADS}) of "
                         f"{n} samples, {k} of {num_levels} levels (at most "
                         f"{MAX_LEVELS}) and a {ph}x{pw} window (even "
                         "width) do not fit together")
    if dtype == torch.float32:
        grid = (num_queries, num_rows)
        threads = min(256, -(-c // 32) * 32)
        smem = (k * heads * win + 5 * k * n) * 4
    else:
        if (c % 64 or c > 256 or heads > 8
                or (k, ph, pw, n // heads) != MSDA_TC_SHAPE):
            raise ValueError(f"{what}: the bf16 kernel takes C a multiple of "
                             "64 up to 256, at most 8 heads and (levels, "
                             f"window, points a head) = {MSDA_TC_SHAPE}, got "
                             f"C = {c}, {heads} heads, "
                             f"{(k, ph, pw, n // heads)}")
        grid = (num_rows * num_queries, 1)
        threads = MSDA_THREADS
        smem = _msda_tc_smem(num_levels, n, c)
    if smem > _kernels.MAX_SMEM:
        raise ValueError(f"{what}: {smem} bytes of shared memory a block do "
                         "not fit")
    dims = [num_rows, num_queries, num_levels, n, heads, c,
            sum(h * w for h, w in shapes), k, ph, pw, threads, smem]
    return SamplingPlan(grid, threads, smem, 0,
                        _kernels.int_array(dims + _level_table(shapes)))


def _check_msda_sel(value, spatial_shapes, loc, attw, heads, patch_h,
                    patch_w, sel_levels):
    what = "_msda_patch_sel"
    _check_devices(what, value, loc, attw)
    _check_storage(what, value, "value")
    for name, t in (("loc", loc), ("attw", attw)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    b, total_hw, c = value.shape
    q, num_levels, n = loc.shape[1:4]
    if (tuple(loc.shape) != (b, q, num_levels, n, 2)
            or tuple(attw.shape) != (b, q, num_levels, n)
            or num_levels != spatial_shapes.num_levels
            or n % heads or heads > MAX_HEADS
            or not 0 < sel_levels <= num_levels):
        raise ValueError(f"{what}: shapes {tuple(value.shape)}, "
                         f"{tuple(loc.shape)}, {tuple(attw.shape)} with "
                         f"{heads} heads (at most {MAX_HEADS}) and "
                         f"{sel_levels} levels do not fit together")
    if patch_w % 2 or any(h_ < patch_h or w_ < patch_w
                          for h_, w_ in spatial_shapes.shapes):
        raise ValueError(f"{what}: a {patch_h}x{patch_w} window (even "
                         f"width) must fit every level of "
                         f"{spatial_shapes.shapes}")
    _check_levels(what, spatial_shapes, total_hw)


def _msda_sel_launch(value, spatial_shapes, loc, attw, heads, patch_h,
                     patch_w, sel_levels):
    what = "_msda_patch_sel"
    b, _, c = value.shape
    q, _, n = loc.shape[1:4]
    plan = plan_msda_sel(b, q, n, heads, c, sel_levels, patch_h, patch_w,
                         value.dtype, spatial_shapes.shapes)
    _check_aligned(what, value, "value")
    dev = value.device
    sampled = torch.empty((b, q, heads, c), dtype=torch.float32, device=dev)
    wsum = torch.empty((b, q, heads), dtype=torch.float32, device=dev)
    _kernels.check(_kernels.load("sampling").simpb_msda_sel(
        *map(_kernels.ptr, (value, loc, attw, sampled, wsum)), plan.dims,
        _kernels.DTYPE_CODE[value.dtype],
        ctypes.c_void_p(_kernels.stream_ptr(value))), what)
    _LAUNCHES["msda_patch_sel"] += 1
    return sampled, wsum


MSDA_BWD_THREADS = 256  # threads of a C1 block
BWD_HEADS = 8  # kernel C's heads at most (csrc/sampling.cu BWD_HEADS)
GV_TILE = 8  # C3's pixel tile (csrc/sampling.cu GV_TILE)


class MsdaBwdPlan(NamedTuple):
    """Kernel C's two launches. C1: one block per (query, camera row),
    `grid` (queries, rows), `threads` and `smem` bytes a block. C3:
    `gvalue_grid` (8x8 pixel tiles of all levels, rows, channel slices of
    32 * `cpl`). `scratch`: the fp32 words C1 hands C3 (each window's
    per-head weights, then its level and base). `dims`: the host int
    array the C entry reads."""
    grid: Tuple[int, int]
    threads: int
    smem: int
    gvalue_grid: Tuple[int, int, int]
    cpl: int
    scratch: int
    dims: ctypes.Array


@functools.lru_cache(maxsize=None)
def plan_msda_sel_backward(num_rows: int, num_queries: int, n: int,
                           heads: int, c: int, k: int, ph: int, pw: int,
                           shapes: Tuple[Tuple[int, int], ...]
                           ) -> MsdaBwdPlan:
    """Kernel C's launches, both dtypes: C1 one block per (query, camera
    row) of MSDA_BWD_THREADS threads, shared memory for the query's
    sampled-value gradient, the pixels' two channel halves of G, the
    window weights and their gradients and the samples; C3 one block per
    (8x8 tile, camera row, channel slice), 32 * cpl channels a slice (cpl
    4 above 64 channels, 2 above 32, else 1). At most BWD_HEADS heads and
    channels a multiple of 8. Raises ValueError on a shape the kernels do
    not take."""
    what = "msda_patch_sel_backward"
    num_levels = len(shapes)
    if (num_levels > MAX_LEVELS or n % heads or not 0 < k <= num_levels
            or pw % 2):
        raise ValueError(f"{what}: {heads} heads of {n} samples, {k} of "
                         f"{num_levels} levels and a {ph}x{pw} window do "
                         "not fit together")
    if any(max(h, w) > MAX_LEVEL_SIDE for h, w in shapes):
        raise ValueError(f"{what}: levels {shapes} exceed "
                         f"{MAX_LEVEL_SIDE} pixels a side")
    if heads > BWD_HEADS or c % 8:
        raise ValueError(f"{what}: the kernel takes at most {BWD_HEADS} "
                         "heads and channels a multiple of 8, got "
                         f"{heads} and {c}")
    kw = k * ph * pw
    smem = 4 * (c * BWD_HEADS + 2 * kw * BWD_HEADS + 2 * kw * heads
                + 6 * k * n)
    if smem > _kernels.MAX_SMEM:
        raise ValueError(f"{what}: {smem} bytes of shared memory a block do "
                         "not fit")
    tiles = sum(-(-h // GV_TILE) * -(-w // GV_TILE) for h, w in shapes)
    cpl = 4 if c > 64 else 2 if c > 32 else 1
    slices = -(-c // (32 * cpl))
    scratch = num_rows * num_queries * k * (heads * ph * pw + 1)
    dims = [num_rows, num_queries, num_levels, n, heads, c,
            sum(h * w for h, w in shapes), k, ph, pw, MSDA_BWD_THREADS, smem,
            tiles, cpl]
    return MsdaBwdPlan((num_queries, num_rows), MSDA_BWD_THREADS, smem,
                       (tiles, num_rows, slices), cpl, scratch,
                       _kernels.int_array(dims + _level_table(shapes)))


def msda_patch_sel_backward(value, spatial_shapes, loc, attw, heads,
                            patch_h, patch_w, sel_levels, grad_sampled,
                            grad_wsum):
    """Kernel C: the gradients (value in its dtype, loc, attw fp32) of
    `_msda_patch_sel` at grad_sampled [B, Q, heads, C] and grad_wsum
    [B, Q, heads]. CUDA tensors only. Deterministic: no atomics, so a
    repeat call gives the same bits."""
    what = "msda_patch_sel_backward"
    _check_msda_sel(value, spatial_shapes, loc, attw, heads, patch_h,
                    patch_w, sel_levels)
    if value.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors")
    b, _, c = value.shape
    q, _, n = loc.shape[1:4]
    plan = plan_msda_sel_backward(b, q, n, heads, c, sel_levels, patch_h,
                                  patch_w, spatial_shapes.shapes)
    dev = value.device
    gs = grad_sampled.float().contiguous()
    gw = grad_wsum.float().contiguous()
    gvalue = torch.empty(value.shape, dtype=value.dtype, device=dev)
    gloc = torch.zeros(loc.shape, dtype=torch.float32, device=dev)
    gattw = torch.zeros(attw.shape, dtype=torch.float32, device=dev)
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=dev)
    _kernels.check(_kernels.load("sampling").simpb_msda_sel_bwd(
        *map(_kernels.ptr, (value, loc, attw, gs, gw, gvalue, gloc, gattw,
                            scratch)),
        plan.dims, _kernels.DTYPE_CODE[value.dtype],
        ctypes.c_void_p(_kernels.stream_ptr(value))), what)
    _LAUNCHES["msda_patch_sel_backward"] += 1
    return gvalue, gloc, gattw


def msda_patch_sel_backward_plain(value, spatial_shapes, loc, attw, heads,
                                  patch_h, patch_w, sel_levels, grad_sampled,
                                  grad_wsum):
    """Kernel C's plain version: autograd through `_msda_patch_sel_plain`
    (fp32 sums, the value gradient rounded once to its dtype)."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(True) for t in (value, loc, attw)]
        sampled, wsum = _msda_patch_sel_plain(
            args[0], spatial_shapes, args[1], args[2], heads, patch_h,
            patch_w, sel_levels)
        return torch.autograd.grad([sampled, wsum], args,
                                   [grad_sampled, grad_wsum])


class _MsdaSelFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, loc, attw, spatial_shapes, heads, patch_h,
                patch_w, sel_levels):
        ctx.save_for_backward(value, loc, attw)
        ctx.args = (spatial_shapes, heads, patch_h, patch_w, sel_levels)
        return _msda_sel_launch(value, spatial_shapes, loc, attw, heads,
                                patch_h, patch_w, sel_levels)

    @staticmethod
    def backward(ctx, grad_sampled, grad_wsum):
        value, loc, attw = ctx.saved_tensors
        ss, heads, ph, pw, k = ctx.args
        grads = msda_patch_sel_backward(value, ss, loc, attw, heads, ph, pw,
                                        k, grad_sampled, grad_wsum)
        return grads + (None,) * 5


class MsdaExactBwdPlan(NamedTuple):
    """Kernel D's two launches. D1: one block per (camera row, query),
    `grid` blocks of `threads` (a warp a head). D2: `gvalue_grid`
    (camera rows, B2_TILE x B2_TILE pixel tiles of all levels, channel
    slices of 256), the tiles numbered smallest level first from
    `first[l]`. `scratch`: the int32 words of D1's records. `dims`: the
    host int array the C entry reads."""
    grid: int
    threads: int
    gvalue_grid: Tuple[int, int, int]
    first: Tuple[int, ...]
    scratch: int
    dims: ctypes.Array


@functools.lru_cache(maxsize=None)
def plan_msda_backward(num_rows: int, num_queries: int, heads: int,
                       num_points: int, c: int,
                       shapes: Tuple[Tuple[int, int], ...]
                       ) -> MsdaExactBwdPlan:
    """Kernel D's launches for `msda` at [num_rows, ΣHW, c] values over
    the levels `shapes`: D1 as the forward (one block per (camera row,
    query), a warp per head, a lane 8 channels), D2 one block per (camera
    row, 8x8 pixel tile, 256 channels). Raises ValueError on a shape the
    kernels do not take: the forward's limits (1 to MSDA_HEADS heads, C a
    multiple of 8, 1 to MAX_LEVELS levels), and levels of at most
    MAX_LEVEL_SIDE pixels a side (D1 packs a corner base in 16 bits an
    axis)."""
    what = "msda_backward"
    num_levels = len(shapes)
    if (not 0 < heads <= MSDA_HEADS or c % 8 or not c
            or not 0 < num_levels <= MAX_LEVELS or num_points < 1
            or num_rows * num_queries < 1):
        raise ValueError(f"{what}: the kernels take 1 to {MSDA_HEADS} "
                         "heads, C a multiple of 8, 1 to "
                         f"{MAX_LEVELS} levels and at least one query, got "
                         f"{heads} heads, C = {c}, {num_levels} levels, "
                         f"{num_rows} x {num_queries} queries")
    if any(max(h, w) > MAX_LEVEL_SIDE for h, w in shapes):
        raise ValueError(f"{what}: levels {shapes} exceed "
                         f"{MAX_LEVEL_SIDE} pixels a side")
    tiles, first = _tile_plan(shapes)
    slices = -(-c // 256)
    records = num_rows * num_levels * num_queries * heads * num_points
    dims = [num_rows, num_queries, heads, num_levels, num_points, c,
            sum(h * w for h, w in shapes), 32 * heads, tiles, slices]
    return MsdaExactBwdPlan(
        num_rows * num_queries, 32 * heads, (num_rows, tiles, slices),
        tuple(first), 5 * records,
        _kernels.int_array(dims + _level_table(shapes) + first))


def _msda_bwd_buffers(value, loc, attw, plan):
    """Kernel D's outputs (gvalue in the value's dtype, gloc and gattw
    fp32, each written whole by the kernels) and its int32 scratch."""
    dev = value.device
    return (torch.empty(value.shape, dtype=value.dtype, device=dev),
            torch.empty(loc.shape, dtype=torch.float32, device=dev),
            torch.empty(attw.shape, dtype=torch.float32, device=dev),
            torch.empty(plan.scratch, dtype=torch.int32, device=dev))


def _msda_bwd_launch(value, loc, attw, gs, gw, plan, buffers, stages=3,
                     tiles=None):
    """Launch kernel D's stages (1 D1, 2 D2; D2 over the tile range
    `tiles`, all tiles when None) into `buffers`."""
    lo, hi = tiles or (0, plan.gvalue_grid[1])
    _kernels.check(_kernels.load("sampling").simpb_msda_bwd(
        *map(_kernels.ptr, (value, loc, attw, gs, gw) + tuple(buffers)),
        plan.dims, _kernels.DTYPE_CODE[value.dtype], stages, lo, hi,
        ctypes.c_void_p(_kernels.stream_ptr(value))), "msda_backward")


def msda_backward(value, spatial_shapes, loc, attw, grad_sampled,
                  grad_wsum):
    """Kernel D: the gradients (value in its dtype, loc, attw fp32) of
    `msda(..., raw_heads=True)` at grad_sampled [B, Q, heads, C] and
    grad_wsum [B, Q, heads]. CUDA tensors only. Deterministic: no
    atomics, so a repeat call gives the same bits."""
    what = "msda_backward"
    _check_msda(value, spatial_shapes, loc, attw)
    if value.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors")
    b, _, c = value.shape
    q, heads, _, num_points = loc.shape[1:5]
    plan = plan_msda_backward(b, q, heads, num_points, c,
                              spatial_shapes.shapes)
    _check_aligned(what, value, "value")
    buffers = _msda_bwd_buffers(value, loc, attw, plan)
    _msda_bwd_launch(value, loc, attw, grad_sampled.float().contiguous(),
                     grad_wsum.float().contiguous(), plan, buffers)
    _LAUNCHES["msda_backward"] += 1
    return buffers[:3]


def msda_backward_plain(value, spatial_shapes, loc, attw, grad_sampled,
                        grad_wsum):
    """Kernel D's plain version: autograd through `msda_plain(...,
    raw_heads=True)` (fp32 sums, the value gradient rounded once to its
    dtype)."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(True) for t in (value, loc, attw)]
        sampled, wsum = msda_plain(args[0], spatial_shapes, args[1],
                                   args[2], raw_heads=True)
        return torch.autograd.grad([sampled, wsum], args,
                                   [grad_sampled, grad_wsum])


def _msda_patch_sel(
    value: torch.Tensor,  # [B, ΣHW, C]
    spatial_shapes: SpatialShapes,
    loc: torch.Tensor,  # [B, Q, L, n, 2] (head-major samples)
    attw: torch.Tensor,  # [B, Q, L, n]
    heads: int,
    patch_h: int,
    patch_w: int,
    sel_levels: int,
):
    """Windowed MSDA at each query's top-`sel_levels` levels (see
    `_msda_patch_sel_plain`) -> (sampled [B, Q, heads, C], wsum
    [B, Q, heads]), float32, differentiable in value, loc and attw.
    Value float32 or bfloat16, locations and weights float32, all
    contiguous; every level must hold the window. On the card bf16
    values run on the tensor cores, fp32 on the CUDA cores."""
    _check_msda_sel(value, spatial_shapes, loc, attw, heads, patch_h,
                    patch_w, sel_levels)
    if value.device.type == "cpu":
        return _msda_patch_sel_plain(value, spatial_shapes, loc, attw, heads,
                                     patch_h, patch_w, sel_levels)
    return _MsdaSelFunction.apply(value, loc, attw, spatial_shapes, heads,
                                  patch_h, patch_w, sel_levels)


# the kernels of this module: (name, wrapper, plain version, the TPU op
# it replaces, an XLA gather there)
KERNELS = (
    ("deformable_aggregation", deformable_aggregation,
     deformable_aggregation_plain, "simpb_tpu/ops/sampling.py:350"),
    ("msda_patch_sel", _msda_patch_sel, _msda_patch_sel_plain,
     "simpb_tpu/ops/sampling.py:892"),
    ("msda", msda, msda_plain, "simpb_tpu/ops/sampling.py:611"),
)
# the backward kernels: (name, wrapper, plain version, the JAX op whose
# gradient it computes)
BACKWARD_KERNELS = (
    ("deformable_aggregation_backward", deformable_aggregation_backward,
     deformable_aggregation_backward_plain, "simpb_tpu/ops/sampling.py:350"),
    ("msda_patch_sel_backward", msda_patch_sel_backward,
     msda_patch_sel_backward_plain, "simpb_tpu/ops/sampling.py:892"),
    ("msda_backward", msda_backward, msda_backward_plain,
     "simpb_tpu/ops/sampling.py:611"),
)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(_LAUNCHES)
