"""Deformable feature aggregation: 3D keypoints -> multi-camera sampling
(port of `simpb_tpu/models/dfa.py`).

Keypoints from the anchor, per-(camera, level, point, group) softmax
fusion weights with a camera embedding from the projection matrices,
projection into every camera, then `ops/sampling.deformable_aggregation`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..core import box3d
from ..ops.format import SpatialShapes
from ..ops.sampling import deformable_aggregation
from .det3d_blocks import SparseBox3DKeyPointsGenerator
from .layers import MLPStack


class DeformableFeatureAggregation(nn.Module):
    def __init__(self, embed_dims: int = 256, num_groups: int = 8,
                 num_levels: int = 4, num_cams: int = 6,
                 num_learnable_pts: int = 6,
                 gather_capacity: Optional[int] = 4096):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_groups = num_groups
        self.num_levels = num_levels
        self.num_cams = num_cams
        self.gather_capacity = gather_capacity
        self.kps_generator = SparseBox3DKeyPointsGenerator(
            embed_dims, num_learnable_pts
        )
        num_pts = self.kps_generator.num_pts
        self.camera_encoder = MLPStack(12, embed_dims, 1, 2)
        self.weights_fc = nn.Linear(embed_dims,
                                    num_groups * num_levels * num_pts)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, instance_feature, anchor, anchor_embed,
                col_feats: torch.Tensor, spatial_shapes: SpatialShapes,
                projection_mat, image_wh):
        """instance_feature [bs, A, C], anchor [bs, A, 11], col_feats
        [bs, cams, ΣHW, C], projection_mat [bs, cams, 4, 4], image_wh
        [bs, cams, 2] -> [bs, A, 2C] (output ‖ instance_feature)."""
        bs, num_anchor = instance_feature.shape[:2]
        key_points = self.kps_generator(anchor, instance_feature)
        num_pts = key_points.shape[2]
        cam_in = projection_mat[:, :, :3].reshape(bs, self.num_cams, 12)
        camera_embed = self.camera_encoder(cam_in)
        feature = (instance_feature + anchor_embed)[:, :, None] + \
            camera_embed[:, None]
        weights = self.weights_fc(feature).reshape(
            bs, num_anchor, -1, self.num_groups
        ).softmax(dim=-2).reshape(
            bs, num_anchor, self.num_cams, self.num_levels, num_pts,
            self.num_groups,
        )
        points_2d = box3d.project_points(key_points, projection_mat, image_wh)
        points_2d = points_2d.permute(0, 2, 3, 1, 4)  # [bs, A, P, cams, 2]
        w = weights.permute(0, 1, 4, 2, 3, 5)  # [bs, A, P, cams, L, G]
        features = deformable_aggregation(
            col_feats, spatial_shapes, points_2d.to(col_feats.dtype),
            w.to(col_feats.dtype), gather_capacity=self.gather_capacity,
        )
        output = self.output_proj(features.to(self.output_proj.weight.dtype))
        return torch.cat([output, instance_feature], dim=-1)
