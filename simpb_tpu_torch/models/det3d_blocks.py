"""3D anchor encoder / refinement / keypoint modules
(port of `simpb_tpu/models/det3d_blocks.py`), computing in `dtype`.

Anchors stay float32: a bf16 refinement delta plus a float32 anchor
promotes to float32 in both frameworks."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..core import box3d
from ..core.box3d import COS_YAW, H, L, SIN_YAW, VX, W, X, Y, Z
from .layers import Dense, MLPStack, Scale


class SparseBox3DEncoder(nn.Module):
    """Anchor state -> embedding: per-component MLP stacks (cat mode)."""

    def __init__(self, embed_dims: Sequence[int] = (128, 32, 32, 64),
                 vel_dims: int = 3, out_loops: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vel_dims = vel_dims
        self.pos_fc = MLPStack(3, embed_dims[0], 1, out_loops, dtype)
        self.size_fc = MLPStack(3, embed_dims[1], 1, out_loops, dtype)
        self.yaw_fc = MLPStack(2, embed_dims[2], 1, out_loops, dtype)
        if vel_dims > 0:
            self.vel_fc = MLPStack(vel_dims, embed_dims[3], 1, out_loops,
                                   dtype)

    def forward(self, anchor: torch.Tensor) -> torch.Tensor:
        feats = [
            self.pos_fc(anchor[..., [X, Y, Z]]),
            self.size_fc(anchor[..., [W, L, H]]),
            self.yaw_fc(anchor[..., [SIN_YAW, COS_YAW]]),
        ]
        if self.vel_dims > 0:
            feats.append(self.vel_fc(anchor[..., VX : VX + self.vel_dims]))
        return torch.cat(feats, dim=-1)


class SparseBox3DRefinementModule(nn.Module):
    """Per-layer 3D refinement: state deltas (+ cls and quality branches
    where the layer reports them). Velocity is translation / dt plus the
    anchor velocity; dt is cast to the deltas' dtype first, as in JAX."""

    def __init__(self, embed_dims: int = 256, output_dim: int = 11,
                 num_cls: int = 10, refine_yaw: bool = True,
                 with_cls: bool = True, with_quality_estimation: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.output_dim = output_dim
        self.refine_yaw = refine_yaw
        self.layers = MLPStack(embed_dims, embed_dims, 2, 2, dtype)
        self.out_fc = Dense(embed_dims, output_dim, dtype=dtype)
        self.scale = Scale(output_dim)
        self.with_cls = with_cls
        self.with_quality = with_cls and with_quality_estimation
        if with_cls:
            self.cls_layers = MLPStack(embed_dims, embed_dims, 1, 2, dtype)
            self.cls_fc = Dense(embed_dims, num_cls, dtype=dtype)
        if self.with_quality:
            self.quality_layers = MLPStack(embed_dims, embed_dims, 1, 2,
                                           dtype)
            self.quality_fc = Dense(embed_dims, 2, dtype=dtype)

    def forward(self, instance_feature, anchor, anchor_embed,
                time_interval, return_cls: bool = True):
        feature = instance_feature + anchor_embed
        out = self.scale(self.out_fc(self.layers(feature)))
        n = 8 if self.refine_yaw else 6
        head_part = out[..., :n] + anchor[..., :n]
        tail = out[..., n:]
        if self.output_dim > 8:
            dt = torch.as_tensor(time_interval, dtype=out.dtype,
                                 device=out.device).reshape(-1)
            velocity = out[..., VX:] / dt[:, None, None] + anchor[..., VX:]
            tail = torch.cat([out[..., n:VX], velocity], dim=-1)
        refined = torch.cat([head_part, tail], dim=-1)
        cls = quality = None
        if return_cls:
            cls = self.cls_fc(self.cls_layers(instance_feature))
            if self.with_quality:
                quality = self.quality_fc(self.quality_layers(feature))
        return refined, cls, quality


class SparseBox3DKeyPointsGenerator(nn.Module):
    """Keypoints = (fixed scales ∪ learnable scales) · size, rotated by
    the yaw and shifted to the anchor centre (7 fixed + 6 learnable)."""

    FIX_SCALE = (
        (0, 0, 0), (0.45, 0, 0), (-0.45, 0, 0), (0, 0.45, 0),
        (0, -0.45, 0), (0, 0, 0.45), (0, 0, -0.45),
    )

    def __init__(self, embed_dims: int = 256, num_learnable_pts: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_learnable_pts = num_learnable_pts
        if num_learnable_pts > 0:
            self.learnable_fc = Dense(embed_dims, num_learnable_pts * 3,
                                      dtype=dtype)

    @property
    def num_pts(self) -> int:
        return len(self.FIX_SCALE) + self.num_learnable_pts

    def forward(self, anchor, instance_feature=None):
        bs, num_anchor = anchor.shape[:2]
        fix = torch.tensor(self.FIX_SCALE, dtype=anchor.dtype,
                           device=anchor.device)
        size = torch.exp(anchor[..., None, [W, L, H]])
        key_points = fix * size
        if self.num_learnable_pts > 0 and instance_feature is not None:
            scale = torch.sigmoid(self.learnable_fc(instance_feature).reshape(
                bs, num_anchor, self.num_learnable_pts, 3
            )) - 0.5
            key_points = torch.cat([key_points, scale * size], dim=-2)
        rot = box3d.yaw_rotation_matrix(anchor)
        key_points = torch.einsum("baij,bapj->bapi", rot, key_points)
        return key_points + anchor[..., None, [X, Y, Z]]
