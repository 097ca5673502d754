"""Adaptive query aggregation: gated 2D -> 3D merge
(port of `simpb_tpu/models/aggregation.py`)."""
from __future__ import annotations

import torch
import torch.nn as nn


class ReWeight(nn.Module):
    """Gate each 2D query by a learned alpha from (query, center count)
    and average the gated queries back onto their 3D parents through the
    transposed incidence matrix (divisor clamped at 1e-5)."""

    def __init__(self, f_dim: int = 256):
        super().__init__()
        self.reduce = nn.Linear(f_dim + 1, f_dim)
        self.alpha = nn.Linear(f_dim, 1)

    def forward(self, query2d, query_pos2d, trans_matrix, center_matrix):
        center_count = center_matrix.sum(-1, keepdim=True)
        param = torch.cat([query2d, center_count.to(query2d.dtype)], dim=-1)
        alpha = torch.sigmoid(self.alpha(torch.relu(self.reduce(param))))
        rw = (trans_matrix * alpha).transpose(1, 2)  # [bs, A, Q]
        divisor = torch.clamp(rw.sum(-1, keepdim=True), min=1e-5)
        return rw @ query2d / divisor, rw @ query_pos2d / divisor
