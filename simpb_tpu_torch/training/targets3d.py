"""3D target assignment and denoising anchors
(port of `simpb_tpu/training/targets3d.py`).

Focal classification cost + weighted-L1 box cost (`cost3d`) -> exact
assignment (`assign_layers`: `training/matching.py`, kernel A on the
card, several layers' matrices in one call) -> scattered fixed-shape
targets (`targets3d`). Ground truth arrives padded to a static count
with a validity mask. `get_dn_anchors` builds the noised GT anchor
groups of denoising; its three uniform draws come from `dn_draws` (a
`torch.Generator`), or are passed in, so that a test can feed it JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..core import box3d
from ..parallel.mesh import batch_slice_draw
from .losses import focal_match_cost
from .matching import batched_assignment

# class labels in dn cls_target: >= 0 matched class; -1 padded GT;
# -3 negative DN sample
DN_NEG_LABEL = -3
DN_PAD_LABEL = -1


class TargetConfig(NamedTuple):
    cls_weight: float = 2.0
    box_weight: float = 0.25
    alpha: float = 0.25
    gamma: float = 2.0
    eps: float = 1e-12
    reg_weights: Tuple[float, ...] = (2.0,) * 3 + (0.5,) * 3 + (0.0,) * 4
    # per-class reg-weight override {class_idx: weights}
    cls_wise_reg_weights: Tuple[Tuple[int, Tuple[float, ...]], ...] = (
        (9, (2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0)),
    )


def scatter_rows(shape, fill, col, valid, src):
    """`out[b, col[b, g]] = src[b, g]` where valid, into a [B, N, ...]
    tensor of `fill` (JAX's `.at[rows, col].set(..., mode="drop")` with
    invalid columns sent out of range)."""
    b, n = shape[:2]
    out = torch.full((b, n + 1) + tuple(shape[2:]), fill, dtype=src.dtype,
                     device=src.device)
    safe = torch.where(valid, col.long(), torch.full_like(col.long(), n))
    rows = torch.arange(b, device=src.device)[:, None].expand_as(safe)
    out[rows, safe] = src
    return out[:, :n]


def encode_gt(gt_boxes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Decoded padded GT [bs, G, 9] -> 10-dim anchor parameterisation,
    zero in padded rows."""
    enc = box3d.encode_box(gt_boxes, vel_dims=gt_boxes.shape[-1] - 7)
    return torch.where(valid[..., None], enc, torch.zeros_like(enc))


def _cls_cost(cls_pred, gt_labels, cfg: TargetConfig):
    return focal_match_cost(cls_pred, gt_labels, cfg.alpha, cfg.gamma,
                            cfg.eps, cfg.cls_weight)


def _reg_weights(gt_enc, gt_labels, cfg: TargetConfig):
    """Per-GT reg weights: nan mask plus the class-wise overrides."""
    w = (~torch.isnan(gt_enc)).float()
    for cls_idx, weights in cfg.cls_wise_reg_weights:
        w = torch.where((gt_labels == cls_idx)[..., None],
                        torch.tensor(weights, device=w.device), w)
    return w


def _box_cost(box_pred, gt_enc, inst_weights, cfg: TargetConfig):
    """Weighted L1 cost [bs, N, G]."""
    d = len(cfg.reg_weights)
    diff = (box_pred[:, :, None, :d]
            - torch.nan_to_num(gt_enc[:, None, :, :d])).abs()
    w = inst_weights[:, None, :, :d] * torch.tensor(
        cfg.reg_weights, device=box_pred.device)
    return (diff * w).sum(-1) * cfg.box_weight


def cost3d(cls_pred, box_pred, gt_boxes, gt_labels, gt_valid,
           cfg: TargetConfig = TargetConfig()):
    """The matching cost of one decoder layer, as the assignment takes
    it: (cost [bs, G, N] detached, gt_enc, inst_w) for box_pred
    [bs, N, D]."""
    gt_enc = encode_gt(gt_boxes, gt_valid)
    inst_w = _reg_weights(gt_enc, gt_labels, cfg)
    cost = _cls_cost(cls_pred, gt_labels, cfg) + _box_cost(
        box_pred, gt_enc, inst_w, cfg)
    cost = torch.nan_to_num(cost, nan=1e8, neginf=1e8, posinf=1e8)
    return cost.transpose(1, 2).detach(), gt_enc, inst_w


def assign_layers(costs: Sequence[torch.Tensor],
                  gt_valid: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The assignments of several layers' costs [bs, G, N] over the same
    ground truth, in one `batched_assignment` call: col [bs, G] each."""
    col = batched_assignment(torch.cat(list(costs)),
                             gt_valid.repeat(len(costs), 1), 1e6)
    return col.chunk(len(costs))


def targets3d(col, gt_enc, inst_w, gt_labels, gt_valid, box_pred,
              num_cls: int):
    """The targets of one layer from its assignment col [bs, G]:
    (cls_target [bs, N] with num_cls = background, box_target
    [bs, N, D], reg_weights [bs, N, D]) for box_pred [bs, N, D]."""
    bs, n, d = box_pred.shape
    cls_target = scatter_rows((bs, n), num_cls, col, gt_valid,
                              gt_labels.to(torch.int32))
    box_target = scatter_rows((bs, n, d), 0.0, col, gt_valid,
                              torch.nan_to_num(gt_enc)[..., :d]
                              .to(box_pred.dtype))
    reg_weights = scatter_rows((bs, n, d), 0.0, col, gt_valid,
                               inst_w[..., :d].to(box_pred.dtype))
    return cls_target, box_target, reg_weights


def sample_targets3d(cls_pred, box_pred, gt_boxes, gt_labels, gt_valid,
                     cfg: TargetConfig = TargetConfig()):
    """Hungarian label assignment. Returns (cls_target [bs, N] with
    num_cls = background, box_target [bs, N, D], reg_weights [bs, N, D])
    for box_pred [bs, N, D]."""
    cost, gt_enc, inst_w = cost3d(cls_pred, box_pred, gt_boxes, gt_labels,
                                  gt_valid, cfg)
    col, = assign_layers([cost], gt_valid)
    return targets3d(col, gt_enc, inst_w, gt_labels, gt_valid, box_pred,
                     cls_pred.shape[-1])


@dataclasses.dataclass
class DnBundle:
    """Fixed-shape denoising inputs for the head (training only).

    num_dn = num_dn_groups * num_per, num_per = 2 * max_dn_gt with
    negatives; group-major along the dn axis: [g0 pos | g0 neg | g1 pos
    | ...]."""

    dn_anchor: torch.Tensor  # [bs, num_dn, 11]
    box_target: torch.Tensor  # [bs, num_dn, 11]
    cls_target: torch.Tensor  # [bs, num_dn] (>=0 pos, -3 neg, -1 pad)
    valid_mask: torch.Tensor  # [bs, num_dn]
    id_target: torch.Tensor  # [bs, num_dn] instance ids (-1 none)
    attn_mask: torch.Tensor  # [num_dn, num_dn] bool, True = blocked
    trans_mask2d: torch.Tensor  # [bs, num_dn, cams] GT camera visibility
    cls_target2d: torch.Tensor  # [bs, num_dn, cams]
    box_target2d: torch.Tensor  # [bs, num_dn, cams, 4] xyxy pixels
    alpha_target2d: torch.Tensor  # [bs, num_dn, cams]
    valid_mask2d: torch.Tensor  # [bs, num_dn, cams]

    def replace(self, **kw) -> "DnBundle":
        return dataclasses.replace(self, **kw)


def dn_draws(generator: torch.Generator, shape: Sequence[int],
             add_neg_dn: bool = True, device=None, num_dn_groups: int = 1):
    """The uniforms of `get_dn_anchors`: positive noise, negative noise
    and the negatives' sign flags, each [num_dn_groups * bs, g, 10]
    (group-major); under a process group this rank's rows of the
    global batch's (`batch_slice_draw` along the batch within each
    group)."""
    n = 3 if add_neg_dn else 1
    gb, rest = shape[0], tuple(shape[1:])
    grouped = (num_dn_groups, gb // num_dn_groups) + rest

    def draw(s):
        return torch.rand((s[0] * s[1],) + rest, generator=generator,
                          device=device).reshape(s)

    return tuple(batch_slice_draw(draw, grouped, axis=1).reshape(
        (gb,) + rest) for _ in range(n))


def get_dn_anchors(
    rng: Union[torch.Generator, Sequence[torch.Tensor]],
    gt_boxes: torch.Tensor,  # [bs, G, 9] decoded (2-D vel), G >= max_dn_gt
    gt_labels: torch.Tensor,  # [bs, G]
    gt_valid: torch.Tensor,  # [bs, G]
    gt_instance_id: Optional[torch.Tensor] = None,  # [bs, G]
    gt_vis2d: Optional[torch.Tensor] = None,  # [bs, G, cams] bool
    gt_boxes2d: Optional[torch.Tensor] = None,  # [bs, G, cams, 4]
    gt_labels2d: Optional[torch.Tensor] = None,  # [bs, G, cams]
    gt_alphas2d: Optional[torch.Tensor] = None,  # [bs, G, cams]
    num_dn_groups: int = 5,
    max_dn_gt: int = 32,
    add_neg_dn: bool = True,
    noise_scale: Tuple[float, ...] = (2.0,) * 3 + (0.5,) * 7,
    num_cams: int = 6,
    cfg: TargetConfig = TargetConfig(),
) -> DnBundle:
    """Noised GT anchor groups and their matched targets. `rng` is a
    generator, or the three uniform tensors of `dn_draws`."""
    bs = gt_boxes.shape[0]
    dev = gt_boxes.device
    g = max_dn_gt
    gt_boxes = gt_boxes[:, :g]
    gt_valid = gt_valid[:, :g]
    gt_labels = torch.where(gt_valid, gt_labels[:, :g].to(torch.int32),
                            torch.full_like(gt_labels[:, :g], DN_PAD_LABEL,
                                            dtype=torch.int32))
    enc = encode_gt(gt_boxes, gt_valid)  # [bs, g, 10]
    if gt_instance_id is None:
        gt_instance_id = torch.full((bs, g), -1, dtype=torch.int32,
                                    device=dev)
    else:
        gt_instance_id = torch.where(
            gt_valid, gt_instance_id[:, :g].to(torch.int32),
            torch.full_like(gt_instance_id[:, :g], -1, dtype=torch.int32))
    if gt_vis2d is None:
        gt_vis2d = torch.zeros((bs, g, num_cams), dtype=torch.bool,
                               device=dev)
        gt_boxes2d = torch.zeros((bs, g, num_cams, 4), device=dev)
        gt_labels2d = torch.full((bs, g, num_cams), -1, dtype=torch.int32,
                                 device=dev)
        gt_alphas2d = torch.zeros((bs, g, num_cams), device=dev)
    gt_vis2d = gt_vis2d[:, :g] & gt_valid[..., None]
    gt_labels2d = torch.where(gt_vis2d, gt_labels2d[:, :g].to(torch.int32),
                              torch.full_like(gt_labels2d[:, :g], -1,
                                              dtype=torch.int32))
    gt_boxes2d = torch.where(gt_vis2d[..., None], gt_boxes2d[:, :g].float(),
                             torch.zeros_like(gt_boxes2d[:, :g].float()))
    gt_alphas2d = torch.where(gt_vis2d, gt_alphas2d[:, :g].float(),
                              torch.zeros_like(gt_alphas2d[:, :g].float()))

    def tile_g(x):
        return x.repeat((num_dn_groups,) + (1,) * (x.dim() - 1))

    enc_t = tile_g(enc)  # [G*bs, g, 10]
    labels_t = tile_g(gt_labels)
    scale = torch.tensor(noise_scale, device=dev)
    if isinstance(rng, torch.Generator):
        rng = dn_draws(rng, enc_t.shape, add_neg_dn, dev, num_dn_groups)
    noise = (rng[0] * 2 - 1) * scale
    dn_anchor = enc_t + noise
    num_per = g
    if add_neg_dn:
        noise_neg = (rng[1] + 1) * scale
        flag = torch.where(rng[2] > 0.5, 1.0, -1.0)
        dn_anchor = torch.cat([dn_anchor, enc_t + noise_neg * flag], dim=1)
        num_per = 2 * g

    # match the noised anchors back to the GT, plain L1 box cost
    cost = _box_cost(dn_anchor, enc_t, torch.ones_like(enc_t), cfg)
    valid_t = tile_g(gt_valid)
    col = batched_assignment(cost.transpose(1, 2), valid_t, 1e6)
    gb = col.shape[0]

    def scatter(src, fill):
        return scatter_rows((gb, num_per) + tuple(src.shape[2:]), fill, col,
                            valid_t, src)

    dn_box_target = scatter(torch.nan_to_num(enc_t), 0.0)
    dn_cls_target = scatter(labels_t, DN_NEG_LABEL)
    dn_id_target = scatter(tile_g(gt_instance_id), -1)
    dn_trans2d = scatter(tile_g(gt_vis2d), False)
    dn_cls2d = scatter(tile_g(gt_labels2d), -4)
    dn_box2d = scatter(tile_g(gt_boxes2d), 0.0)
    dn_alpha2d = scatter(tile_g(gt_alphas2d), 0.0)

    # valid = matched to a real GT, or a negative sample of a real GT
    pad_labels = torch.cat([labels_t, labels_t], 1) if add_neg_dn \
        else labels_t
    valid_mask = dn_cls_target >= 0
    if add_neg_dn:
        valid_mask = valid_mask | ((pad_labels >= 0)
                                   & (dn_cls_target == DN_NEG_LABEL))
    l2d = tile_g(gt_labels2d)
    pad_labels2d = torch.cat([l2d, l2d], 1) if add_neg_dn else l2d
    valid_mask2d = dn_cls2d >= 0
    if add_neg_dn:
        valid_mask2d = valid_mask2d | ((pad_labels2d >= 0) & (dn_cls2d == -4))

    def regroup(x):  # [G*bs, ...] -> [bs, G*num_per, ...]
        x = x.reshape((num_dn_groups, bs) + tuple(x.shape[1:]))
        x = x.movedim(1, 0)
        return x.reshape((bs, num_dn_groups * num_per) + tuple(x.shape[3:]))

    block = torch.block_diag(*[torch.ones((num_per, num_per), device=dev)]
                             * num_dn_groups)
    attn_mask = block == 0  # True = blocked across groups
    dn_anchor = torch.cat([dn_anchor, torch.zeros(
        dn_anchor.shape[:-1] + (box3d.STATE_DIM - dn_anchor.shape[-1],),
        device=dev)], dim=-1)
    return DnBundle(
        dn_anchor=regroup(dn_anchor),
        box_target=regroup(dn_box_target),
        cls_target=regroup(dn_cls_target),
        valid_mask=regroup(valid_mask),
        id_target=regroup(dn_id_target),
        attn_mask=attn_mask,
        trans_mask2d=regroup(dn_trans2d),
        cls_target2d=regroup(dn_cls2d),
        box_target2d=regroup(dn_box2d),
        alpha_target2d=regroup(dn_alpha2d),
        valid_mask2d=regroup(valid_mask2d),
    )
