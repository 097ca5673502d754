"""2D anchor encoder / refinement modules
(port of `simpb_tpu/models/det2d_blocks.py`, released configuration:
sine-embedded encoder, cls and alpha branches, no depth branch)."""
from __future__ import annotations

import torch
import torch.nn as nn

from .layers import MLPStack, Scale, inverse_sigmoid, pos2posemb2d


class SparseBox2DEncoder(nn.Module):
    """2D anchor -> sine posemb of (cx, cy) -> MLP stack."""

    def __init__(self, embed_dims: int = 256):
        super().__init__()
        self.query_embeddings2d = MLPStack(256, embed_dims, 1, 2)

    def forward(self, box2d: torch.Tensor) -> torch.Tensor:
        return self.query_embeddings2d(pos2posemb2d(box2d[..., :2]))


class SparseBox2DRefinementModule(nn.Module):
    """Sigmoid-space 2D box delta + cls + alpha (sin, cos)."""

    def __init__(self, embed_dims: int = 256, output_dim: int = 4,
                 num_cls: int = 10, alpha_dim: int = 2):
        super().__init__()
        self.layers = MLPStack(embed_dims, embed_dims, 2, 2)
        self.out_fc = nn.Linear(embed_dims, output_dim)
        self.scale = Scale(output_dim)
        self.cls_layers = MLPStack(embed_dims, embed_dims, 1, 2)
        self.cls_fc = nn.Linear(embed_dims, num_cls)
        self.alpha_layers = MLPStack(embed_dims, embed_dims, 1, 2)
        self.alpha_fc = nn.Linear(embed_dims, alpha_dim)
        self.alpha_scale = Scale(alpha_dim)

    def forward(self, instance_feature, anchor2d, anchor2d_embed):
        out = self.scale(self.out_fc(self.layers(
            instance_feature + anchor2d_embed
        )))
        na = anchor2d.shape[-1]
        out = torch.cat(
            [out[..., :na] + inverse_sigmoid(anchor2d).to(out.dtype),
             out[..., na:]], dim=-1,
        )
        cls = self.cls_fc(self.cls_layers(instance_feature))
        alpha = self.alpha_scale(
            self.alpha_fc(self.alpha_layers(instance_feature))
        )
        return torch.sigmoid(out), cls, alpha
