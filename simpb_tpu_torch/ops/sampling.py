"""Deformable sampling ops in plain PyTorch.

Port of the serving path of `simpb_tpu/ops/sampling.py`:

* `deformable_aggregation` — fused multi-camera multi-scale bilinear
  sample + weighted sum (DFA), with `gather_capacity` valid-slot
  compaction;
* `msda_patch` / `_msda_patch_sel` — windowed multi-scale deformable
  attention with per-query top-k level selection and `raw_heads`
  output (the value projection is applied after sampling by the
  caller).

Sampling semantics, as in the JAX package: pixel position is
`loc * size - 0.5`; out-of-border bilinear corners weigh zero; DFA drops
a whole sample outside (0, 1). The JAX package reads its samples from a
"pair table" (two adjacent pixels per row, a row layout for the TPU
gather engine); every corner that layout fetches from a neighbouring
row carries zero weight, so sampling the pixels directly, with indices
clamped into range, gives the same values. Indices are always clamped
explicitly: unlike JAX gathers, torch indexing does not clamp.

On the TPU these ops were XLA gathers, not Pallas kernels; their
hand-written Hopper kernels come later.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .format import SpatialShapes


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


def deformable_aggregation(
    col_feats: torch.Tensor,  # [bs, cams, ΣHW, C]
    spatial_shapes: SpatialShapes,
    points_2d: torch.Tensor,  # [bs, A, P, cams, 2]
    weights: torch.Tensor,  # [bs, A, P, cams, L, G]
    gather_capacity: Optional[int] = None,
) -> torch.Tensor:
    """Fused multi-camera multi-scale deformable aggregation.

    With `gather_capacity` M < A*P, each camera samples only its first M
    in-range (anchor, point) slots in anchor order (the score
    `in_range * 2s - arange` and a top-k, tie-free by construction);
    results scatter back to their anchors. Returns [bs, A, C] float32.
    """
    bs, cams, total_hw, c = col_feats.shape
    _, num_anchor, num_pts = points_2d.shape[:3]
    num_levels = spatial_shapes.num_levels
    num_groups = weights.shape[-1]
    group_dims = c // num_groups
    b = bs * cams
    s = num_anchor * num_pts
    dev = col_feats.device

    loc = points_2d.permute(0, 3, 1, 2, 4).reshape(b, s, 2)
    w_all = weights.permute(0, 3, 1, 2, 4, 5).reshape(
        b, s, num_levels, num_groups
    )
    in_range = (
        (loc[..., 0] > 0.0) & (loc[..., 0] < 1.0)
        & (loc[..., 1] > 0.0) & (loc[..., 1] < 1.0)
    )
    if gather_capacity is not None and gather_capacity < s:
        m = gather_capacity
        score = in_range.float() * (2.0 * s) - torch.arange(
            s, dtype=torch.float32, device=dev
        )
        _, sel = topk_stable(score, m)  # [b, m]
        loc = torch.gather(loc, 1, sel[..., None].expand(b, m, 2))
        w_all = torch.gather(
            w_all, 1, sel[..., None, None].expand(b, m, num_levels, num_groups)
        )
        sel_valid = torch.gather(in_range, 1, sel)
        anchor_idx = sel // num_pts
    else:
        m = s
        sel_valid = in_range
        anchor_idx = (torch.arange(s, device=dev) // num_pts)[None].expand(
            b, s
        )

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
    """`msda_patch` at each query's top-`sel_levels` levels by attention
    mass; per-level constants come from small lookup vectors. Returns
    (sampled [B, Q, heads, C], wsum [B, Q, heads])."""
    b, total_hw, c = value.shape
    q, num_levels, n = loc.shape[1:4]
    num_points = n // heads
    k = sel_levels
    ph, pw = patch_h, patch_w
    dev = value.device
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
    patch = _take_rows(value.reshape(b * total_hw, c), rows).reshape(
        b, q, k, ph * pw, c
    )
    wpix = _window_weights(px, py, keep, a_s, base_x, base_y, ph, pw)
    wpix = wpix.reshape(b, q, k, heads, num_points, ph * pw).sum(4)
    weighted = torch.einsum("bqkhe,bqkec->bqhc", wpix, patch.float())
    return weighted, wpix.sum(-1).sum(2)
