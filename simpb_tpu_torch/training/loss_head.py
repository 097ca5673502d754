"""The training loss of the SimPB head (port of
`simpb_tpu/training/loss_head.py`).

Per-decoder-layer 3D assignment losses (`loss3d`), per-camera 2D losses
(`loss2d`), each assigning all its layers' matrices in one call; the
3D + 2D denoising losses (`dn_loss`) and the dense depth loss,
assembled by `total_loss` under the JAX package's key names
(`loss_cls3d_0`, `loss_box3d_dn_0`, `loss_alpha2d_1`, ...). Everything is
masked fixed-shape arithmetic; the positive counts are global over the
batch, as in the JAX package. Under a process group they are global over
the ranks too (`_count`, the depth loss's denominator): each rank's loss
is its local sum over the global count, so the ranks' losses sum to the
loss of the global batch, JAX's under `pjit`. Every other reduction here
and in `losses.py`, `targets3d.py`, `targets2d.py` and `dn.py` is within
one sample (a matrix's costs, a row's targets) or a plain sum.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..configs.base import TrainConfig
from ..parallel.mesh import all_reduce_sum
from . import losses as L
from .targets2d import Target2DConfig, cost2d, targets2d
from .targets3d import (
    DnBundle, TargetConfig, assign_layers, cost3d, targets3d,
)


def _count(mask: torch.Tensor) -> torch.Tensor:
    """The positives of the global batch (all ranks), at least 1."""
    return torch.clamp(all_reduce_sum(mask.sum().float()), min=1.0)


def loss3d(outputs: Dict, gt_boxes, gt_labels, gt_valid, tc: TrainConfig,
           target_cfg: TargetConfig,
           cls_threshold_to_reg: float = 0.05) -> Dict[str, torch.Tensor]:
    out = {}
    d = len(tc.reg_weights)
    layers = list(zip(outputs["classification"], outputs["prediction"],
                      outputs["quality"]))
    costs = [cost3d(cls, reg[..., :d], gt_boxes, gt_labels, gt_valid,
                    target_cfg) for cls, reg, _ in layers]
    # every layer's matrices in one assignment call
    cols = assign_layers([c for c, _, _ in costs], gt_valid) if costs \
        else ()
    for idx, ((cls, reg, qt), (_, gt_enc, inst_w), col) in enumerate(
            zip(layers, costs, cols)):
        reg_weights = torch.tensor(tc.reg_weights, device=reg.device)
        reg = reg[..., :d]
        cls_t, box_t, w = targets3d(col, gt_enc, inst_w, gt_labels,
                                    gt_valid, reg, cls.shape[-1])
        mask = ~torch.all(box_t == 0, dim=-1)
        num_pos = _count(mask)
        if cls_threshold_to_reg > 0:
            mask = mask & (torch.sigmoid(cls.amax(-1)) > cls_threshold_to_reg)
        cls_loss = L.sigmoid_focal_loss(
            cls.reshape(-1, cls.shape[-1]), cls_t.reshape(-1),
            avg_factor=num_pos, loss_weight=tc.cls_weight)
        w_full = w * reg_weights * mask[..., None].float()
        reg_out = L.sparse_box3d_loss(
            reg.reshape(-1, d), torch.nan_to_num(box_t).reshape(-1, d),
            weight=w_full.reshape(-1, d), avg_factor=num_pos,
            quality=qt.reshape(-1, 2) if qt is not None else None,
            cls_target=cls_t.reshape(-1), quality_mask=mask.reshape(-1),
            box_loss_weight=tc.box_weight, suffix=f"3d_{idx}")
        out[f"loss_cls3d_{idx}"] = cls_loss
        out.update(reg_out)
    return out


def loss2d(outputs: Dict, gt_boxes2d, gt_labels2d, gt_alphas2d, gt_valid2d,
           image_wh: Tuple[int, int], tc: TrainConfig,
           t2_cfg: Target2DConfig = Target2DConfig()
           ) -> Dict[str, torch.Tensor]:
    out = {}
    img_w, img_h = image_wh
    layers = list(zip(outputs["classification2d"], outputs["prediction2d"],
                      outputs["prediction_alpha2d"], outputs["allocations"]))
    costs = [cost2d(cls, reg, alloc.valid, gt_boxes2d, gt_labels2d,
                    gt_valid2d, image_wh, t2_cfg)
             for cls, reg, _, alloc in layers]
    # every layer's matrices in one assignment call
    cols = assign_layers(costs, gt_valid2d.reshape(costs[0].shape[:2])) \
        if costs else ()
    for idx, ((cls, reg, alpha, alloc), col) in enumerate(zip(layers, cols)):
        factor = torch.tensor([img_w, img_h, img_w, img_h],
                              dtype=torch.float32, device=reg.device)
        cls_t, box_t, alpha_t, w = targets2d(
            col, gt_boxes2d, gt_labels2d, gt_alphas2d, gt_valid2d,
            cls.shape[1])
        mask = ~torch.all(box_t == 0, dim=-1) & alloc.valid
        num_pos = _count(mask)
        cls_loss = L.sigmoid_focal_loss(
            cls.reshape(-1, cls.shape[-1]), cls_t.reshape(-1),
            avg_factor=num_pos, loss_weight=tc.cls_weight2d)
        wm = w * mask[..., None].float()
        out[f"loss_cls2d_{idx}"] = cls_loss
        out[f"loss_iou2d_{idx}"] = L.giou_loss(
            L.bbox_cxcywh_to_xyxy(reg) * factor, box_t, weight=wm,
            avg_factor=num_pos, loss_weight=tc.iou_weight2d)
        out[f"loss_box2d_{idx}"] = L.l1_loss(
            reg, L.bbox_xyxy_to_cxcywh(box_t) / factor, weight=wm,
            avg_factor=num_pos, loss_weight=tc.bbox_weight2d)
        out[f"loss_alpha2d_{idx}"] = L.l1_loss(
            alpha, alpha_t, weight=wm[..., :2], avg_factor=num_pos,
            loss_weight=tc.alpha_weight2d)
    return out


def dn_loss(outputs: Dict, tc: TrainConfig,
            num_single_frame_decoder: int = 1,
            image_wh: Tuple[int, int] = (704, 256)
            ) -> Dict[str, torch.Tensor]:
    out = {}
    if "dn_prediction" not in outputs:
        return out
    d = len(tc.reg_weights)
    first: DnBundle = outputs["dn_bundle_first"]
    temp: DnBundle = outputs["dn_bundle_temp"]
    for idx, (cls, reg) in enumerate(zip(outputs["dn_classification"],
                                         outputs["dn_prediction"])):
        reg_weights = torch.tensor(tc.reg_weights, device=reg.device)
        bundle = temp if idx >= num_single_frame_decoder else first
        valid = bundle.valid_mask
        pos = valid & (bundle.cls_target >= 0)
        num_dn_pos = _count(valid)
        neg1 = torch.full_like(bundle.cls_target, -1)
        out[f"loss_cls3d_dn_{idx}"] = L.sigmoid_focal_loss(
            cls.reshape(-1, cls.shape[-1]),
            torch.where(valid, bundle.cls_target, neg1).reshape(-1),
            weight=valid.reshape(-1).float(), avg_factor=num_dn_pos,
            loss_weight=tc.cls_weight)
        w = pos[..., None].float() * reg_weights
        out.update(L.sparse_box3d_loss(
            reg[..., :d].reshape(-1, d),
            bundle.box_target[..., :d].reshape(-1, d),
            weight=w.reshape(-1, d), avg_factor=num_dn_pos, quality=None,
            cls_target=torch.where(pos, bundle.cls_target, neg1).reshape(-1),
            box_loss_weight=tc.box_weight, suffix=f"3d_dn_{idx}"))

    if "dn_prediction2d" in outputs and outputs["dn_slot_targets"]:
        img_w, img_h = image_wh
        for idx, (cls_p, box_p, alpha_p, tgt) in enumerate(zip(
                outputs["dn_classification2d"], outputs["dn_prediction2d"],
                outputs["dn_prediction_alpha2d"],
                outputs["dn_slot_targets"])):
            factor = torch.tensor([img_w, img_h, img_w, img_h],
                                  dtype=torch.float32, device=box_p.device)
            valid = tgt["valid"]
            num_pos = _count(valid)
            num_cls = cls_p.shape[-1]
            # mmdet mean reduction over the valid [N_valid, C] elements
            out[f"loss_cls2d_dn_{idx}"] = L.sigmoid_focal_loss(
                cls_p.reshape(-1, num_cls),
                torch.where(valid, tgt["cls"],
                            torch.full_like(tgt["cls"], -1)).reshape(-1),
                weight=valid.reshape(-1).float(),
                avg_factor=num_pos * num_cls, loss_weight=tc.cls_weight2d)
            pos = valid & (tgt["cls"] >= 0)
            wm = pos[..., None].float()
            out[f"loss_iou2d_dn_{idx}"] = L.giou_loss(
                L.bbox_cxcywh_to_xyxy(box_p) * factor, tgt["box"],
                weight=wm.repeat_interleave(4, -1), avg_factor=num_pos,
                loss_weight=tc.iou_weight2d)
            out[f"loss_box2d_dn_{idx}"] = L.l1_loss(
                box_p, L.bbox_xyxy_to_cxcywh(tgt["box"]) / factor,
                weight=wm, avg_factor=num_pos, loss_weight=tc.bbox_weight2d)
            alpha_sc = torch.stack([torch.sin(tgt["alpha"]),
                                    torch.cos(tgt["alpha"])], dim=-1)
            out[f"loss_alpha2d_dn_{idx}"] = L.l1_loss(
                alpha_p, alpha_sc, weight=wm.repeat_interleave(2, -1),
                avg_factor=num_pos, loss_weight=tc.alpha_weight2d)
    return out


def dense_depth_loss(depth_preds: Sequence[torch.Tensor],
                     gt_depths: Sequence[torch.Tensor],
                     max_depth: float = 60.0,
                     loss_weight: float = 0.2) -> torch.Tensor:
    """Sparse L1 depth loss; gt_depths per level [bs, cams, H, W], zero
    where unsupervised."""
    total = 0.0
    num_levels = len(depth_preds)
    for pred, gt in zip(depth_preds, gt_depths):
        pred = pred.float().reshape(-1)
        gt = gt.float().reshape(-1)
        fg = (gt > 0.0) & torch.isfinite(pred)
        pred = pred.clamp(0.0, max_depth)
        err = torch.where(fg, (pred - gt).abs(), torch.zeros_like(pred)).sum()
        denom = torch.clamp(all_reduce_sum(fg.sum().float()) * num_levels,
                            min=1.0)
        total = total + err / denom * loss_weight
    return total


def total_loss(outputs: Dict, batch: Dict, tc: TrainConfig,
               target_cfg: TargetConfig = TargetConfig(),
               image_wh: Tuple[int, int] = (704, 256),
               num_single_frame_decoder: int = 1
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss dict and its sum."""
    loss_dict = {}
    loss_dict.update(loss3d(outputs, batch["gt_boxes3d"],
                            batch["gt_labels3d"], batch["gt_valid3d"], tc,
                            target_cfg))
    if outputs.get("prediction2d"):
        loss_dict.update(loss2d(
            outputs, batch["gt_boxes2d"], batch["gt_labels2d"],
            batch["gt_alphas2d"], batch["gt_valid2d"], image_wh, tc))
    loss_dict.update(dn_loss(outputs, tc, num_single_frame_decoder,
                             image_wh))
    if "depth_preds" in outputs and "gt_depth" in batch:
        loss_dict["loss_dense_depth"] = dense_depth_loss(
            outputs["depth_preds"], batch["gt_depth"])
    total = sum(loss_dict.values())
    return total, loss_dict
