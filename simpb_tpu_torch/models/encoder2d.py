"""Deformable-DETR 2D feature encoder, the head's `encoder2d` hook
(port of `simpb_tpu/models/encoder2d.py`).

Off in every released configuration (`encoder2d_layers=0`). When on,
`SimPBHead` runs `DeformableEncoder2D` over each camera's packed
multi-level features, and the 2D cross-attention samples the refined
memory instead of the raw FPN column (with `share_encoder2d`, so does
DFA). `DeformableDecoder2D` is the iterative-refinement decoder over
such a memory; no configuration instantiates it.

As in JAX, the padding masks of the reference are all-valid, so the
reference points are the pixel centres and the sine positional encoding
is a constant of the level shapes (computed in numpy, as JAX does, and
kept on the device per level layout). Cameras fold into the batch. The
sampling is the exact `msda` (`ops/sampling.py`): on the card the exact
MSDA kernel, and kernel D as its backward; here every feature slot is a
query, 14,960 of them a camera row at 704x256 and 59,840 at 1408x512.
Module and parameter names are JAX's (`layer{i}_attn/value_proj`, ...),
so `utils/convert.py` maps the tree by name.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.format import SpatialShapes
from ..ops.sampling import msda
from .group_attn import msda_offset_bias_init
from .layers import (Dense, LayerNorm, MultiheadAttention, cast, dropout,
                     inverse_sigmoid)


def sine_positional_encoding(
    h: int,
    w: int,
    num_feats: int = 128,
    temperature: float = 10000.0,
    normalize: bool = True,
    offset: float = -0.5,
    scale: float = 2.0 * np.pi,
    eps: float = 1e-6,
) -> np.ndarray:
    """mmdet `SinePositionalEncoding` on an all-valid mask: [h, w,
    2 * num_feats] float32, the y-embedding channels first (numpy, a
    copy of JAX's)."""
    y_embed = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    x_embed = np.ones((h, 1)) * np.arange(1, w + 1, dtype=np.float64)[None, :]
    if normalize:
        y_embed = (y_embed + offset) / (y_embed[-1:, :] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_feats, dtype=np.float64)
    dim_t = temperature ** (2.0 * (dim_t // 2) / num_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    # interleave sin/cos over channel pairs (mmdet stack(..., dim=3).view)
    pos_x = np.stack(
        [np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], axis=-1
    ).reshape(h, w, num_feats)
    pos_y = np.stack(
        [np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], axis=-1
    ).reshape(h, w, num_feats)
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)


def _packed_pos_and_refs(
    spatial_shapes: SpatialShapes, num_feats: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-slot sine position embedding [ΣHW, 2 num_feats] and normalised
    reference point [ΣHW, 2] (x, y) of the packed layout."""
    pos, refs = [], []
    for h, w in spatial_shapes.shapes:
        pos.append(sine_positional_encoding(h, w, num_feats).reshape(h * w, -1))
        ys, xs = np.meshgrid(
            (np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij"
        )
        refs.append(np.stack([xs, ys], -1).reshape(h * w, 2))
    return (
        np.concatenate(pos, 0),
        np.concatenate(refs, 0).astype(np.float32),
    )


class MSDAAttention(nn.Module):
    """mmcv `MultiScaleDeformableAttention`: `value_proj`, the exact
    `msda` over the projected values (heads split, no raw heads), then
    `output_proj`, dropout and the residual. The encoder's
    self-attention (the queries are the feature slots) and the decoder's
    cross-attention differ only in the reference points' rank ([Q, 2]
    shared across the batch, or [B, Q, 2]) and query_pos."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.drop = dropout
        n = num_heads * num_levels * num_points
        self.value_proj = Dense(embed_dims, embed_dims, dtype=dtype)
        self.sampling_offsets = Dense(embed_dims, 2 * n, dtype=dtype)
        self.attention_weights = Dense(embed_dims, n, dtype=dtype)
        self.output_proj = Dense(embed_dims, embed_dims, dtype=dtype)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                msda_offset_bias_init(num_heads, num_levels, num_points)))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, query_pos: Optional[torch.Tensor],
                reference_points: torch.Tensor, value: torch.Tensor,
                spatial_shapes: SpatialShapes) -> torch.Tensor:
        """query [B, Q, C], query_pos [Q, C] / [B, Q, C] / None,
        reference_points [Q, 2] / [B, Q, 2] in (0, 1), value [B, ΣHW, C]
        -> [B, Q, C]."""
        b, q, _ = query.shape
        heads, levels, points = (self.num_heads, self.num_levels,
                                 self.num_points)
        identity = query
        if query_pos is not None:
            query = query + cast(query_pos, query.dtype)
        v = cast(self.value_proj(value), value.dtype)
        offsets = self.sampling_offsets(query).reshape(
            b, q, heads, levels, points, 2)
        attn = torch.softmax(
            self.attention_weights(query).reshape(b, q, heads,
                                                  levels * points), dim=-1,
        ).reshape(b, q, heads, levels, points)
        normalizer = torch.tensor(
            [(w_, h_) for h_, w_ in spatial_shapes.shapes],
            dtype=offsets.dtype, device=offsets.device)
        if reference_points.dim() == 2:  # [Q, 2] shared across the batch
            reference_points = reference_points[None]
        loc = (reference_points[:, :, None, None, None, :]
               + offsets / normalizer[None, None, None, :, None, :])
        out = msda(v, spatial_shapes, cast(loc, torch.float32),
                   cast(attn, torch.float32))
        out = dropout(self.output_proj(out), self.drop)
        return identity + out


class EncoderFFN(nn.Module):
    """mmcv `FFN`: fc1, ReLU, dropout, fc2, dropout, residual."""

    def __init__(self, embed_dims: int = 256,
                 feedforward_channels: int = 1024, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop = dropout
        self.fc1 = Dense(embed_dims, feedforward_channels, dtype=dtype)
        self.fc2 = Dense(feedforward_channels, embed_dims, dtype=dtype)

    def forward(self, x):
        y = dropout(torch.relu(self.fc1(x)), self.drop)
        return x + dropout(self.fc2(y), self.drop)


class DeformableEncoder2D(nn.Module):
    """The `encoder2d` hook: `num_layers` x (MSDA self-attention, LN, FFN,
    LN) over the packed per-camera features, with the sine and level
    position embeddings (reference simpb_head.py:214-276)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 num_layers: int = 1, feedforward_channels: int = 1024,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_layers = num_layers
        self.level_embeds = nn.Parameter(torch.randn(num_levels, embed_dims))
        for i in range(num_layers):
            self.add_module(f"layer{i}_attn", MSDAAttention(
                embed_dims, num_heads, num_levels, num_points, dropout,
                dtype))
            self.add_module(f"layer{i}_norm1", LayerNorm(embed_dims, dtype))
            self.add_module(f"layer{i}_ffn", EncoderFFN(
                embed_dims, feedforward_channels, dropout, dtype))
            self.add_module(f"layer{i}_norm2", LayerNorm(embed_dims, dtype))
        # (shapes, device) -> (sine embedding, reference points, level of
        # each slot): constants of the level layout, made once
        self._layouts: Dict[tuple, Tuple[torch.Tensor, ...]] = {}

    def _layout(self, spatial_shapes: SpatialShapes, device):
        def build():
            pos, refs = _packed_pos_and_refs(spatial_shapes,
                                             self.embed_dims // 2)
            lvl = np.repeat(np.arange(spatial_shapes.num_levels),
                            spatial_shapes.sizes)
            return tuple(torch.from_numpy(a).to(device)
                         for a in (pos, refs, lvl))

        if torch.compiler.is_exporting():  # constants of the traced graph
            return build()
        key = (spatial_shapes.shapes, str(device))
        if key not in self._layouts:
            self._layouts[key] = build()
        return self._layouts[key]

    def forward(self, col_feats: torch.Tensor,
                spatial_shapes: SpatialShapes) -> torch.Tensor:
        """col_feats [bs, cams, ΣHW, C] -> the refined memory, same shape
        and type."""
        bs, cams, n, c = col_feats.shape
        pos, refs, lvl = self._layout(spatial_shapes, col_feats.device)
        pos = pos + self.level_embeds[lvl]
        x = col_feats.reshape(bs * cams, n, c)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}_attn")(x, pos, refs, x,
                                                spatial_shapes)
            x = getattr(self, f"layer{i}_norm1")(x)
            x = getattr(self, f"layer{i}_ffn")(x)
            x = getattr(self, f"layer{i}_norm2")(x)
        return cast(x.reshape(bs, cams, n, c), col_feats.dtype)


class DeformableDecoder2D(nn.Module):
    """`QueryGroupDeformableDetrTransformerDecoder` (reference
    group_attn.py:259-346): `num_layers` x (self-attention, LN, MSDA
    cross-attention, LN, FFN, LN), each layer's reference points refined
    through `reg_branch` when one is given (detached, as JAX's
    stop_gradient), the intermediate outputs stacked."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 num_layers: int = 2, feedforward_channels: int = 1024,
                 dropout: float = 0.1, return_intermediate: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.return_intermediate = return_intermediate
        for i in range(num_layers):
            self.add_module(f"layer{i}_self_attn", MultiheadAttention(
                embed_dims, num_heads, dtype))
            self.add_module(f"layer{i}_norm1", LayerNorm(embed_dims, dtype))
            self.add_module(f"layer{i}_cross_attn", MSDAAttention(
                embed_dims, num_heads, num_levels, num_points, dropout,
                dtype))
            self.add_module(f"layer{i}_norm2", LayerNorm(embed_dims, dtype))
            self.add_module(f"layer{i}_ffn", EncoderFFN(
                embed_dims, feedforward_channels, dropout, dtype))
            self.add_module(f"layer{i}_norm3", LayerNorm(embed_dims, dtype))

    def forward(self, query: torch.Tensor, query_pos: Optional[torch.Tensor],
                reference_points: torch.Tensor, value: torch.Tensor,
                spatial_shapes: SpatialShapes, reg_branch=None):
        """query [B, Q, C], reference_points [B, Q, 2] in (0, 1), value
        [B, ΣHW, C] -> (stacked outputs [layers, B, Q, C], stacked
        reference points [layers, B, Q, 2]) with `return_intermediate`,
        else the last of each."""
        intermediate, intermediate_refs = [], []
        x = query
        for i in range(self.num_layers):
            q_in = x + query_pos if query_pos is not None else x
            sa = getattr(self, f"layer{i}_self_attn")(q_in, q_in, x)
            x = getattr(self, f"layer{i}_norm1")(x + sa)
            x = getattr(self, f"layer{i}_cross_attn")(
                x, query_pos, reference_points, value, spatial_shapes)
            x = getattr(self, f"layer{i}_norm2")(x)
            x = getattr(self, f"layer{i}_ffn")(x)
            x = getattr(self, f"layer{i}_norm3")(x)
            if reg_branch is not None:
                delta = reg_branch(x)
                reference_points = torch.sigmoid(
                    delta[..., :2] + inverse_sigmoid(reference_points)
                ).detach()
            if self.return_intermediate:
                intermediate.append(x)
                intermediate_refs.append(reference_points)
        if self.return_intermediate:
            return torch.stack(intermediate), torch.stack(intermediate_refs)
        return x, reference_points
