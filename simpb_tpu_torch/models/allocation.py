"""Static-shape query allocation, 3D anchors -> per-camera 2D slots
(port of the inference path of `simpb_tpu/models/allocation.py`).

Every camera owns K slots filled in anchor order with the anchors valid
in it (center strictly inside the image, or any corner with positive
depth inside); padded slots carry zero trans rows, anchors and
reference depth. Query group g is the slice [g*K, (g+1)*K).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import box3d
from ..ops.sampling import one_hot, topk_stable


class Allocation(NamedTuple):
    """Fixed-shape allocation result; Q = cams * K."""

    anchor2d: torch.Tensor  # [bs, Q, 2] normalised reference points
    ref_depth: torch.Tensor  # [bs, Q, 1] |center depth|, 0 when invalid
    valid: torch.Tensor  # [bs, Q] bool
    center_flag: torch.Tensor  # [bs, Q] bool
    parent_idx: torch.Tensor  # [bs, Q] int64 index into the 3D anchors
    trans_matrix: torch.Tensor  # [bs, Q, A] one-hot incidence
    center_matrix: torch.Tensor  # [bs, Q, A] one-hot, center-valid only


def allocate_queries(
    anchor3d: torch.Tensor,  # [bs, A, 11]
    projection_mat: torch.Tensor,  # [bs, cams, 4, 4]
    image_wh: tuple,
    capacity: int,
    limit_anchor_size: tuple = (35.0, 35.0, 10.0),
) -> Allocation:
    bs, num_anchor = anchor3d.shape[:2]
    num_cams = projection_mat.shape[1]
    img_w, img_h = image_wh

    corners = box3d.box_corners(anchor3d, size_clip=limit_anchor_size)
    pts = torch.cat([corners, anchor3d[..., None, :3]], dim=-2)
    hom = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    proj = torch.einsum("bnij,bapj->bnapi", projection_mat, hom)
    depth = proj[..., 2]
    xy = proj[..., :2] / torch.clamp(depth[..., None], min=1e-5)

    center_xy = xy[..., 8, :]  # [bs, cams, A, 2]
    center_depth = depth[..., 8]
    corner_xy = xy[..., :8, :]
    corner_depth = depth[..., :8]
    center_valid = (
        (center_xy[..., 0] > 0) & (center_xy[..., 0] < img_w)
        & (center_xy[..., 1] > 0) & (center_xy[..., 1] < img_h)
    )
    corner_in = (
        (corner_xy[..., 0] > 0) & (corner_xy[..., 0] < img_w)
        & (corner_xy[..., 1] > 0) & (corner_xy[..., 1] < img_h)
        & (corner_depth > 0)
    )
    corner_valid = corner_in.any(-1)

    # fallback reference point: clamped corner-bbox center
    x_min = corner_xy[..., 0].amin(-1).clamp(0, img_w)
    x_max = corner_xy[..., 0].amax(-1).clamp(0, img_w)
    y_min = corner_xy[..., 1].amin(-1).clamp(0, img_h)
    y_max = corner_xy[..., 1].amax(-1).clamp(0, img_h)
    fallback = torch.stack([(x_min + x_max) / 2, (y_min + y_max) / 2], -1)
    ref_xy = torch.where(center_valid[..., None], center_xy, fallback)
    valid = center_valid | corner_valid

    # static top-K per camera: valid anchors in anchor order (tie-free)
    idx = torch.arange(num_anchor, dtype=torch.float32,
                       device=anchor3d.device)
    score = valid.float() * (2.0 * num_anchor) - idx
    _, sel = topk_stable(score, capacity)  # [bs, cams, K]

    take = lambda x: torch.gather(x, -1, sel)
    slot_valid = take(valid)
    slot_center = take(center_valid) & slot_valid
    slot_xy = torch.gather(ref_xy, -2, sel[..., None].expand(
        sel.shape + (2,)))
    slot_depth = take(center_depth).abs()
    wh = torch.tensor([img_w, img_h], dtype=slot_xy.dtype,
                      device=slot_xy.device)
    anchor2d = torch.where(slot_valid[..., None], slot_xy / wh,
                           torch.zeros_like(slot_xy))
    ref_depth = torch.where(slot_valid, slot_depth,
                            torch.zeros_like(slot_depth))[..., None]

    q = num_cams * capacity
    flat = lambda x: x.reshape((bs, q) + tuple(x.shape[3:]))
    parent_idx = flat(sel)
    valid_f = flat(slot_valid)
    center_f = flat(slot_center)
    onehot = one_hot(parent_idx, num_anchor)
    return Allocation(
        anchor2d=flat(anchor2d),
        ref_depth=flat(ref_depth),
        valid=valid_f,
        center_flag=center_f,
        parent_idx=parent_idx,
        trans_matrix=onehot * valid_f[..., None].float(),
        center_matrix=onehot * center_f[..., None].float(),
    )


def dispatch_to_2d(alloc: Allocation,
                   instance_feature: torch.Tensor) -> torch.Tensor:
    """3D instance features -> 2D query slots (gather + mask)."""
    c = instance_feature.shape[-1]
    gathered = torch.gather(
        instance_feature, 1,
        alloc.parent_idx[..., None].expand(alloc.parent_idx.shape + (c,)),
    )
    return gathered * alloc.valid[..., None].to(gathered.dtype)
