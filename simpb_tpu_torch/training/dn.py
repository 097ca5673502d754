"""Temporal denoising cache as explicit state (port of
`simpb_tpu/training/dn.py`).

`DnState` holds `num_temp_dn_groups` groups of `num_per` noised
instances carried to the next frame; `update_dn` re-injects them into
the current frame's DN block, matched by instance id, and `cache_dn`
keeps a random subset of the groups. Its draw lives in `cache_dn_draw`
(a `torch.Generator`), or is passed in as scores.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from .targets3d import DnBundle


@dataclasses.dataclass
class DnState:
    """Cached temporal DN groups."""

    feature: torch.Tensor  # [bs, Gt, num_per, C]
    anchor: torch.Tensor  # [bs, Gt, num_per, 11]
    cls_target: torch.Tensor  # [bs, Gt, num_per]
    valid_mask: torch.Tensor  # [bs, Gt, num_per]
    id_target: torch.Tensor  # [bs, Gt, num_per]
    trans_mask2d: torch.Tensor  # [bs, Gt, num_per, cams]
    valid_mask2d: torch.Tensor  # [bs, Gt, num_per, cams]
    cls_target2d: torch.Tensor  # [bs, Gt, num_per, cams]
    alpha_target2d: torch.Tensor  # [bs, Gt, num_per, cams]

    @staticmethod
    def init(bs, num_temp_groups, num_per, embed_dims, num_cams,
             device=None) -> "DnState":
        s = (bs, num_temp_groups, num_per)
        i32 = torch.int32
        return DnState(
            feature=torch.zeros(s + (embed_dims,), device=device),
            anchor=torch.zeros(s + (11,), device=device),
            cls_target=torch.full(s, -1, dtype=i32, device=device),
            valid_mask=torch.zeros(s, dtype=torch.bool, device=device),
            id_target=torch.full(s, -1, dtype=i32, device=device),
            trans_mask2d=torch.zeros(s + (num_cams,), dtype=torch.bool,
                                     device=device),
            valid_mask2d=torch.zeros(s + (num_cams,), dtype=torch.bool,
                                     device=device),
            cls_target2d=torch.full(s + (num_cams,), -1, dtype=i32,
                                    device=device),
            alpha_target2d=torch.zeros(s + (num_cams,), device=device),
        )


def update_dn(instance_feature, anchor, bundle: DnBundle,
              state: Optional[DnState], temp_valid_mask: torch.Tensor,
              num_anchor3d: int, num_dn_groups: int,
              num_temp_dn_groups: int
              ) -> Tuple[torch.Tensor, torch.Tensor, DnBundle]:
    """Re-inject cached temporal DN groups: the first
    `num_temp_dn_groups` groups' features and anchors come from the
    cache, their box targets from the current frame's targets of the
    same instance id; unmatched cached instances get cls -1 and zero
    masks. Returns (instance_feature, anchor, the "temp" bundle used by
    decoder layers >= num_single_frame_decoder)."""
    if state is None:
        return instance_feature, anchor, bundle
    bs = instance_feature.shape[0]
    num_dn = instance_feature.shape[1] - num_anchor3d
    num_per = num_dn // num_dn_groups
    gt_ = num_temp_dn_groups

    def grp(x):
        return x.reshape((bs, num_dn_groups, num_per) + tuple(x.shape[2:]))

    dn_feat = grp(instance_feature[:, num_anchor3d:])
    dn_anchor = grp(anchor[:, num_anchor3d:])
    dn_reg = grp(bundle.box_target)
    dn_id = grp(bundle.id_target)
    dn_box2d = grp(bundle.box_target2d)

    match = (state.id_target[..., None] == dn_id[:, :gt_, None]) & (
        state.id_target[..., None] >= 0)
    no_match = ~match.any(-1)
    temp_reg = torch.einsum("bgtc,bgcd->bgtd", match.to(dn_reg.dtype),
                            dn_reg[:, :gt_])
    temp_box2d = torch.einsum("bgtc,bgcnd->bgtnd",
                              match.to(dn_box2d.dtype), dn_box2d[:, :gt_])
    nm = no_match[..., None]
    temp_cls = torch.where(no_match, -1, state.cls_target).to(
        state.cls_target.dtype)
    temp_trans2d = state.trans_mask2d & ~nm
    temp_valid2d = state.valid_mask2d & ~nm
    temp_cls2d = torch.where(nm, -1, state.cls_target2d).to(
        state.cls_target2d.dtype)
    temp_alpha2d = torch.where(nm, 0.0, state.alpha_target2d)

    def merge(cur, temp):
        m = temp_valid_mask.reshape((bs,) + (1,) * (cur.dim() - 1))
        head_part = torch.where(m, temp.to(cur.dtype), cur[:, :gt_])
        out = torch.cat([head_part, cur[:, gt_:]], dim=1)
        return out.reshape((bs, num_dn_groups * num_per)
                           + tuple(out.shape[3:]))

    new_bundle = bundle.replace(
        box_target=merge(dn_reg, temp_reg),
        cls_target=merge(grp(bundle.cls_target), temp_cls),
        valid_mask=merge(grp(bundle.valid_mask), state.valid_mask),
        id_target=merge(dn_id, state.id_target),
        trans_mask2d=merge(grp(bundle.trans_mask2d), temp_trans2d),
        valid_mask2d=merge(grp(bundle.valid_mask2d), temp_valid2d),
        cls_target2d=merge(grp(bundle.cls_target2d), temp_cls2d),
        box_target2d=merge(dn_box2d, temp_box2d),
        alpha_target2d=merge(grp(bundle.alpha_target2d), temp_alpha2d),
    )
    instance_feature = torch.cat(
        [instance_feature[:, :num_anchor3d], merge(dn_feat, state.feature)],
        dim=1)
    anchor = torch.cat([anchor[:, :num_anchor3d],
                        merge(dn_anchor, state.anchor)], dim=1)
    return instance_feature, anchor, new_bundle


def cache_dn_draw(generator: torch.Generator, num_dn_groups: int,
                  device=None) -> torch.Tensor:
    """`cache_dn`'s draw: one uniform score a DN group."""
    return torch.rand((num_dn_groups,), generator=generator, device=device)


def cache_dn(rng: Union[torch.Generator, torch.Tensor], dn_instance_feature,
             dn_anchor, bundle: DnBundle, num_dn_groups: int,
             num_temp_dn_groups: int) -> DnState:
    """Cache the `num_temp_dn_groups` DN groups of the lowest scores (in
    group order) for the next frame; `rng` is a generator or the
    [num_dn_groups] scores of `cache_dn_draw`."""
    bs, num_dn = dn_instance_feature.shape[:2]
    num_per = num_dn // num_dn_groups
    scores = rng if isinstance(rng, torch.Tensor) else cache_dn_draw(
        rng, num_dn_groups, dn_instance_feature.device)
    keep = torch.sort(torch.argsort(scores, stable=True)[
        :num_temp_dn_groups]).values

    def grp(x):
        return x.reshape((bs, num_dn_groups, num_per)
                         + tuple(x.shape[2:]))[:, keep]

    return DnState(
        feature=grp(dn_instance_feature).detach().float(),
        anchor=grp(dn_anchor).detach().float(),
        cls_target=grp(bundle.cls_target),
        valid_mask=grp(bundle.valid_mask),
        id_target=grp(bundle.id_target),
        trans_mask2d=grp(bundle.trans_mask2d),
        valid_mask2d=grp(bundle.valid_mask2d),
        cls_target2d=grp(bundle.cls_target2d),
        alpha_target2d=grp(bundle.alpha_target2d),
    )
