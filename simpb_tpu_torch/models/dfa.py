"""Deformable feature aggregation: 3D keypoints -> multi-camera sampling
(port of `simpb_tpu/models/dfa.py`).

Keypoints from the anchor, per-(camera, level, point, group) softmax
fusion weights with a camera embedding from the projection matrices,
projection into every camera, then `ops/sampling.deformable_aggregation`.
In `dtype`: the weights and their softmax, the camera embedding and
`output_proj`; the points and weights are cast to the features' dtype
for the kernel, which returns float32, as in JAX. In training,
`attn_drop` drops whole (camera, point) pairs of the weights with the
installed dropout generator (`point_keep_draw`). With a `guards`
collector the forward appends `dfa_overflow`, the most in-range
(anchor, point) slots a camera holds beyond the gather capacity (JAX's
sown counter; `dfa_level_dropped_mass` belongs to `dfa_sel_levels`,
which is not ported).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..core import box3d
from ..ops.format import SpatialShapes
from ..ops.sampling import deformable_aggregation
from ..parallel.mesh import batch_slice_draw
from .det3d_blocks import SparseBox3DKeyPointsGenerator
from .layers import Dense, MLPStack, current_dropout_generator


def point_keep_draw(generator: torch.Generator, shape, device):
    """DFA's dropout draw: one uniform a (batch, anchor, camera, point),
    shaped [bs, A, cams, 1, P, 1]; this rank's rows of the global
    batch's (`batch_slice_draw`)."""
    return batch_slice_draw(
        lambda s: torch.rand(s, generator=generator, device=device), shape)


class DeformableFeatureAggregation(nn.Module):
    def __init__(self, embed_dims: int = 256, num_groups: int = 8,
                 num_levels: int = 4, num_cams: int = 6,
                 num_learnable_pts: int = 6,
                 gather_capacity: Optional[int] = 4096,
                 dtype: torch.dtype = torch.float32,
                 attn_drop: float = 0.0):
        super().__init__()
        self.attn_drop = attn_drop
        self.embed_dims = embed_dims
        self.num_groups = num_groups
        self.num_levels = num_levels
        self.num_cams = num_cams
        self.gather_capacity = gather_capacity
        self.kps_generator = SparseBox3DKeyPointsGenerator(
            embed_dims, num_learnable_pts, dtype
        )
        num_pts = self.kps_generator.num_pts
        self.camera_encoder = MLPStack(12, embed_dims, 1, 2, dtype)
        self.weights_fc = Dense(embed_dims, num_groups * num_levels * num_pts,
                                dtype=dtype)
        self.output_proj = Dense(embed_dims, embed_dims, dtype=dtype)

    def forward(self, instance_feature, anchor, anchor_embed,
                col_feats: torch.Tensor, spatial_shapes: SpatialShapes,
                projection_mat, image_wh, guards: Optional[dict] = None):
        """instance_feature [bs, A, C], anchor [bs, A, 11], col_feats
        [bs, cams, ΣHW, C], projection_mat [bs, cams, 4, 4], image_wh
        [bs, cams, 2] -> [bs, A, 2C] (output ‖ instance_feature).
        `guards`: a collector dict the overflow counter is appended to."""
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
        gen = current_dropout_generator()
        if self.attn_drop > 0 and gen is not None:
            u = point_keep_draw(gen, (bs, num_anchor, self.num_cams, 1,
                                      num_pts, 1), weights.device)
            weights = torch.where(u > self.attn_drop, weights,
                                  torch.zeros_like(weights)) / (
                1 - self.attn_drop)
        points_2d = box3d.project_points(key_points, projection_mat, image_wh)
        points_2d = points_2d.permute(0, 2, 3, 1, 4)  # [bs, A, P, cams, 2]
        w = weights.permute(0, 1, 4, 2, 3, 5)  # [bs, A, P, cams, L, G]
        if guards is not None:
            # the in-range test of the op's compaction, on the points
            # before their cast to the features' dtype, as in JAX
            in_r = ((points_2d[..., 0] > 0.0) & (points_2d[..., 0] < 1.0)
                    & (points_2d[..., 1] > 0.0) & (points_2d[..., 1] < 1.0))
            slots = num_anchor * num_pts
            cap = self.gather_capacity
            cap_eff = cap if cap is not None and cap < slots else slots
            guards.setdefault("dfa_overflow", []).append(
                (in_r.sum((1, 2)).max() - cap_eff).clamp(min=0).float())
        features = deformable_aggregation(
            col_feats, spatial_shapes, points_2d.to(col_feats.dtype),
            w.to(col_feats.dtype), gather_capacity=self.gather_capacity,
        )
        output = self.output_proj(features)
        return torch.cat([output, instance_feature], dim=-1)
