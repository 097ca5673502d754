"""3D box decoding / top-k post-processing, device part
(port of `simpb_tpu/models/decoder3d.py`). Fixed-shape outputs with a
validity mask; top-k and the quality re-sort are stable sorts, so ties
keep the lower index first as in JAX."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core import box3d
from ..core.box3d import CNS
from ..ops.sampling import topk_stable


def decode_boxes3d(
    cls_scores: torch.Tensor,  # [bs, A, num_cls] logits
    box_preds: torch.Tensor,  # [bs, A, 11]
    instance_id: Optional[torch.Tensor] = None,  # [bs, A]
    quality: Optional[torch.Tensor] = None,  # [bs, A, 2]
    num_output: int = 300,
    score_threshold: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """Keys: boxes_3d [bs, K, 10], scores_3d, labels_3d, cls_scores,
    valid, anchor_idx (and instance_ids when tracking), each [bs, K]."""
    scores = torch.sigmoid(cls_scores)
    bs, num_pred, num_cls = scores.shape
    if instance_id is not None:
        flat_scores, cls_ids_full = scores.max(dim=-1)
        topk_scores, anchor_idx = topk_stable(flat_scores, num_output)
        labels = torch.gather(cls_ids_full, 1, anchor_idx)
    else:
        topk_scores, indices = topk_stable(
            scores.reshape(bs, num_pred * num_cls), num_output
        )
        anchor_idx = indices // num_cls
        labels = indices % num_cls
    valid = (topk_scores >= score_threshold if score_threshold is not None
             else torch.ones_like(topk_scores, dtype=torch.bool))
    cls_scores_origin = topk_scores
    if quality is not None:
        centerness = torch.gather(quality[..., CNS], 1, anchor_idx)
        reweighted = topk_scores * torch.sigmoid(centerness)
        _, order = torch.sort(-reweighted, dim=1, stable=True)
        topk_scores = torch.gather(reweighted, 1, order)
        cls_scores_origin = torch.gather(cls_scores_origin, 1, order)
        labels = torch.gather(labels, 1, order)
        valid = torch.gather(valid, 1, order)
        anchor_idx = torch.gather(anchor_idx, 1, order)
    boxes = torch.gather(
        box_preds, 1,
        anchor_idx[..., None].expand(anchor_idx.shape + box_preds.shape[2:]),
    )
    out = {
        "boxes_3d": box3d.decode_box(boxes),
        "scores_3d": topk_scores,
        "labels_3d": labels,
        "cls_scores": cls_scores_origin,
        "valid": valid,
        "anchor_idx": anchor_idx,
    }
    if instance_id is not None:
        out["instance_ids"] = torch.gather(instance_id, 1, anchor_idx)
    return out
