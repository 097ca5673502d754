"""Detection losses (port of `simpb_tpu/training/losses.py`).

mmdet-equivalent formulas on fixed-shape tensors with explicit element
weights / masks and an `avg_factor` (mmdet's reduction contract):
sigmoid focal loss, L1, BCE with logits, gaussian focal, GIoU, the focal
matching cost and the composite `sparse_box3d_loss`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core.box3d import CNS, COS_YAW, SIN_YAW, X, Y, YNS, Z


def _reduce(loss, weight, avg_factor, loss_weight):
    if weight is not None:
        loss = loss * weight
    loss = loss.sum()
    if avg_factor is not None:
        loss = loss / torch.clamp(avg_factor, min=1.0)
    return loss * loss_weight


def sigmoid_focal_loss(
    logits: torch.Tensor,  # [N, C]
    labels: torch.Tensor,  # [N] int, label == C (or < 0) means background
    weight: Optional[torch.Tensor] = None,  # [N]
    avg_factor: Optional[torch.Tensor] = None,
    alpha: float = 0.25,
    gamma: float = 2.0,
    loss_weight: float = 1.0,
) -> torch.Tensor:
    num_cls = logits.shape[-1]
    onehot = (labels[..., None] == torch.arange(
        num_cls, device=labels.device)).to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = -(onehot * F.logsigmoid(logits)
           + (1 - onehot) * F.logsigmoid(-logits))
    pt = (1 - p) * onehot + p * (1 - onehot)
    focal = (alpha * onehot + (1 - alpha) * (1 - onehot)) * pt ** gamma
    w = weight[..., None] if weight is not None else None
    return _reduce(ce * focal, w, avg_factor, loss_weight)


def focal_match_cost(cls_pred, gt_labels, alpha: float, gamma: float,
                     eps: float, weight: float) -> torch.Tensor:
    """Focal classification matching cost [B, N, G] (mmdet
    FocalLossCost)."""
    p = torch.sigmoid(cls_pred)
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    diff = pos - neg  # [B, N, C]
    labels = gt_labels.clamp(0, cls_pred.shape[-1] - 1).long()
    idx = labels[:, None, :].expand(diff.shape[0], diff.shape[1],
                                    labels.shape[1])
    return torch.gather(diff, 2, idx) * weight


def l1_loss(pred, target, weight=None, avg_factor=None,
            loss_weight: float = 1.0) -> torch.Tensor:
    return _reduce((pred - target).abs(), weight, avg_factor, loss_weight)


def bce_loss(logits, target, weight=None, avg_factor=None,
             loss_weight: float = 1.0) -> torch.Tensor:
    """Binary cross entropy with logits (mmdet CrossEntropyLoss
    sigmoid)."""
    loss = -(target * F.logsigmoid(logits)
             + (1 - target) * F.logsigmoid(-logits))
    return _reduce(loss, weight, avg_factor, loss_weight)


def gaussian_focal_loss(pred, target, weight=None, avg_factor=None,
                        alpha: float = 2.0, gamma: float = 4.0,
                        loss_weight: float = 1.0,
                        eps: float = 1e-12) -> torch.Tensor:
    """`pred` are probabilities; `target == 1` marks positives."""
    pos = (target == 1.0).to(pred.dtype)
    neg = 1.0 - pos
    pos_loss = -torch.log(pred + eps) * (1 - pred) ** alpha * pos
    neg_loss = (-torch.log(1 - pred + eps) * pred ** alpha
                * (1 - target) ** gamma * neg)
    return _reduce(pos_loss + neg_loss, weight, avg_factor, loss_weight)


def bbox_cxcywh_to_xyxy(box: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5,
                        cy + h * 0.5], dim=-1)


def bbox_xyxy_to_cxcywh(box: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = box.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1],
                       dim=-1)


def giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned (broadcast) xyxy boxes [..., 4] -> [...]."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = ((boxes1[..., 2] - boxes1[..., 0]).clamp(min=0.0)
          * (boxes1[..., 3] - boxes1[..., 1]).clamp(min=0.0))
    a2 = ((boxes2[..., 2] - boxes2[..., 0]).clamp(min=0.0)
          * (boxes2[..., 3] - boxes2[..., 1]).clamp(min=0.0))
    union = a1 + a2 - inter
    iou = inter / union.clamp(min=1e-6)
    lt_c = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_c = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_c = (rb_c - lt_c).clamp(min=0.0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / area_c.clamp(min=1e-6)


def giou_loss(pred_xyxy, target_xyxy, weight=None, avg_factor=None,
              loss_weight: float = 1.0) -> torch.Tensor:
    loss = 1.0 - giou(pred_xyxy, target_xyxy)
    if weight is not None and weight.dim() == loss.dim() + 1:
        weight = weight.mean(-1)
    return _reduce(loss, weight, avg_factor, loss_weight)


def sparse_box3d_loss(
    box: torch.Tensor,  # [N, 10] predictions
    box_target: torch.Tensor,  # [N, 10]
    weight: torch.Tensor,  # [N, 10]
    avg_factor: torch.Tensor,
    quality: Optional[torch.Tensor] = None,  # [N, 2]
    cls_target: Optional[torch.Tensor] = None,  # [N]
    quality_mask: Optional[torch.Tensor] = None,  # [N] bool
    box_loss_weight: float = 0.25,
    cls_allow_reverse: tuple = (5,),  # barrier
    suffix: str = "",
) -> Dict[str, torch.Tensor]:
    """L1 box loss + centerness BCE (target exp(-|Δxyz|)) + yawness
    gaussian focal (target: sign of the yaw cosine similarity), with the
    yaw reversal allowed for direction-symmetric classes."""
    yaw_pred = box[..., [SIN_YAW, COS_YAW]]
    yaw_tgt = box_target[..., [SIN_YAW, COS_YAW]]
    cos_sim = (yaw_pred * yaw_tgt).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(yaw_pred, dim=-1)
        * torch.linalg.vector_norm(yaw_tgt, dim=-1), min=1e-8)
    if cls_allow_reverse and cls_target is not None:
        allowed = torch.tensor(cls_allow_reverse, device=cls_target.device)
        reverse = (cos_sim < 0) & torch.isin(cls_target, allowed)
        yaw_tgt = torch.where(reverse[..., None], -yaw_tgt, yaw_tgt)
        box_target = torch.cat([box_target[..., :SIN_YAW], yaw_tgt,
                                box_target[..., COS_YAW + 1:]], dim=-1)
        cos_sim = torch.where(reverse, -cos_sim, cos_sim)
    out = {f"loss_box{suffix}": l1_loss(
        box, box_target, weight=weight, avg_factor=avg_factor,
        loss_weight=box_loss_weight)}
    if quality is not None:
        qm = quality_mask.to(box.dtype) if quality_mask is not None else None
        cns = quality[..., CNS]
        yns = torch.sigmoid(quality[..., YNS])
        cns_target = torch.exp(-torch.linalg.vector_norm(
            box_target[..., [X, Y, Z]] - box[..., [X, Y, Z]], dim=-1))
        out[f"loss_cns{suffix}"] = bce_loss(cns, cns_target, weight=qm,
                                            avg_factor=avg_factor)
        yns_target = (cos_sim > 0).to(box.dtype)
        out[f"loss_yns{suffix}"] = gaussian_focal_loss(
            yns, yns_target, weight=qm, avg_factor=avg_factor)
    return out
