"""Per-camera 2D target assignment (port of
`simpb_tpu/training/targets2d.py`).

Per-(sample, camera) focal + L1 + GIoU matching costs (`cost2d`) ->
exact assignment (`targets3d.assign_layers`, kernel A on the card) ->
scattered per-slot targets (`targets2d`). 2D
ground truth arrives padded per camera: boxes [bs, cams, G2, 4] in pixel
xyxy of the network input, labels / alphas / valid likewise.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .losses import (
    bbox_cxcywh_to_xyxy, bbox_xyxy_to_cxcywh, focal_match_cost, giou,
)
from .targets3d import assign_layers, scatter_rows


class Target2DConfig(NamedTuple):
    cls_weight: float = 2.0
    reg_weight: float = 5.0
    iou_weight: float = 2.0
    eps: float = 1e-12
    alpha: float = 0.25
    gamma: float = 2.0


def cost2d(cls_pred, box_pred, slot_valid, gt_boxes, gt_labels, gt_valid,
           image_wh: Tuple[int, int],
           cfg: Target2DConfig = Target2DConfig()) -> torch.Tensor:
    """The matching cost of one layer, one matrix a (sample, camera), as
    the assignment takes it: [bs * cams, G2, K] detached (padded slots
    at the matrix's largest valid cost)."""
    bs, q, num_cls = cls_pred.shape
    cams, g2 = gt_boxes.shape[1:3]
    k = q // cams
    img_w, img_h = image_wh
    factor = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32,
                          device=cls_pred.device)
    b = bs * cams
    cls_p = cls_pred.detach().reshape(b, k, num_cls)
    box_p = box_pred.detach().reshape(b, k, 4)
    valid_p = slot_valid.reshape(b, k)
    gt_b = gt_boxes.reshape(b, g2, 4).float()
    gt_l = gt_labels.reshape(b, g2)
    gt_v = gt_valid.reshape(b, g2)

    cls_cost = focal_match_cost(cls_p, gt_l, cfg.alpha, cfg.gamma, cfg.eps,
                                cfg.cls_weight)
    gt_cxcywh = bbox_xyxy_to_cxcywh(gt_b) / factor
    reg_cost = (box_p[:, :, None] - gt_cxcywh[:, None]).abs().sum(-1) \
        * cfg.reg_weight
    pred_xyxy = bbox_cxcywh_to_xyxy(box_p) * factor
    iou_cost = -giou(pred_xyxy[:, :, None], gt_b[:, None]) * cfg.iou_weight
    cost = cls_cost + reg_cost + iou_cost  # [B, K, G2]
    # padded prediction slots get the per-matrix max
    cmax = torch.where(gt_v[:, None], cost,
                       torch.full_like(cost, float("-inf"))).amax(dim=(1, 2))
    cmax = torch.nan_to_num(cmax, neginf=0.0)
    cost = torch.where(valid_p[:, :, None], cost, cmax[:, None, None])
    cost = torch.nan_to_num(cost, nan=1e8, posinf=1e8, neginf=1e8)
    return cost.transpose(1, 2)


def targets2d(col, gt_boxes, gt_labels, gt_alphas, gt_valid, q: int):
    """The per-slot targets of one layer from its assignment col
    [bs * cams, G2], q = cams * K slots a sample: (cls_target int (-1 =
    unmatched), box_target pixel xyxy, alpha_target (sin, cos),
    reg_weights [.., 4]), each [bs, q, ...]."""
    bs, cams, g2 = gt_boxes.shape[:3]
    b, k = bs * cams, q // cams
    gt_b = gt_boxes.reshape(b, g2, 4).float()
    gt_l = gt_labels.reshape(b, g2)
    gt_a = gt_alphas.reshape(b, g2).float()
    gt_v = gt_valid.reshape(b, g2)
    cls_t = scatter_rows((b, k), -1, col, gt_v, gt_l.to(torch.int32))
    box_t = scatter_rows((b, k, 4), 0.0, col, gt_v, gt_b)
    alpha_sc = torch.stack([torch.sin(gt_a), torch.cos(gt_a)], dim=-1)
    alpha_t = scatter_rows((b, k, 2), 0.0, col, gt_v, alpha_sc)
    w_t = scatter_rows((b, k, 4), 0.0, col, gt_v, torch.ones_like(gt_b))
    unfold = lambda x: x.reshape((bs, q) + tuple(x.shape[2:]))
    return unfold(cls_t), unfold(box_t), unfold(alpha_t), unfold(w_t)


def sample_targets2d(cls_pred, box_pred, slot_valid, gt_boxes, gt_labels,
                     gt_alphas, gt_valid, image_wh: Tuple[int, int],
                     cfg: Target2DConfig = Target2DConfig()):
    """cls_pred [bs, cams*K, C] logits, box_pred [bs, cams*K, 4]
    normalised cxcywh, slot_valid [bs, cams*K]. Returns per-slot targets
    [bs, cams*K, ...]: (cls_target int (-1 = unmatched), box_target pixel
    xyxy, alpha_target (sin, cos), reg_weights [.., 4])."""
    cost = cost2d(cls_pred, box_pred, slot_valid, gt_boxes, gt_labels,
                  gt_valid, image_wh, cfg)
    col, = assign_layers([cost], gt_valid.reshape(cost.shape[:2]))
    return targets2d(col, gt_boxes, gt_labels, gt_alphas, gt_valid,
                     cls_pred.shape[1])


def trans_cost3d(cost2d, slot_valid, gt_valid, gt_2d_3d_map, trans_matrix,
                 num_gt3d: int) -> torch.Tensor:
    """Fold the 2D matching costs [bs, cams, K, G2] into the 3D cost map
    [bs, A3, num_gt3d] (the reference's `trans_cost`, built but never
    invoked by the released head; kept for surface parity)."""
    bs, cams, k, g2 = cost2d.shape
    q2 = cams * k
    valid_q = slot_valid.reshape(bs, cams, k)
    pairs = valid_q[..., None] & gt_valid[:, :, None, :]
    neg = torch.full_like(cost2d, float("-inf"))
    big = torch.where(pairs, cost2d, neg).amax(dim=(1, 2, 3))
    big = torch.nan_to_num(big, neginf=0.0)
    filled = torch.where(pairs, cost2d, big[:, None, None, None])
    ext = torch.zeros((bs, cams, k, cams, g2), dtype=cost2d.dtype,
                      device=cost2d.device) + big[:, None, None, None, None]
    cam_eye = torch.eye(cams, dtype=torch.bool,
                        device=cost2d.device)[None, :, None, :, None]
    ext = torch.where(cam_eye, filled[:, :, :, None, :], ext).reshape(
        bs, q2, cams * g2)
    idx = gt_2d_3d_map.clamp(0, num_gt3d - 1).long()
    map_oh = (idx[..., None] == torch.arange(num_gt3d, device=idx.device)
              ).to(cost2d.dtype) * gt_valid[..., None].to(cost2d.dtype)
    map_oh = map_oh.reshape(bs, cams * g2, num_gt3d)
    floor = 1e-5
    per_gt3d = torch.einsum("bqt,btg->bqg", ext, map_oh) / map_oh.sum(
        1).clamp(min=floor)[:, None]
    tm_t = trans_matrix.to(cost2d.dtype).transpose(1, 2)
    folded = torch.einsum("baq,bqg->bag", tm_t, per_gt3d) / tm_t.sum(
        -1).clamp(min=floor)[..., None]
    mask = (folded.sum(1) == 0)[:, None, :] | (folded.sum(2) == 0)[:, :, None]
    fmax = folded.amax(dim=(1, 2), keepdim=True)
    return torch.where(mask, fmax, folded)
