"""Shared neural building blocks (port of `simpb_tpu/models/layers.py`).

Parameter names follow the JAX tree (`fc0`, `ln0`, `q_proj`, ...);
`utils/convert.py` maps a JAX Dense kernel [in, out] to a Linear weight
[out, in]. LayerNorm eps is 1e-5 everywhere.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

LN_EPS = 1e-5


class MLPStack(nn.Module):
    """`linear_relu_ln(embed, in_loops, out_loops)`: out_loops x
    [in_loops x (Linear, ReLU), LayerNorm]."""

    def __init__(self, in_dims: int, embed_dims: int, in_loops: int = 1,
                 out_loops: int = 2):
        super().__init__()
        self.order = []
        idx = 0
        d = in_dims
        for _ in range(out_loops):
            for _ in range(in_loops):
                self.add_module(f"fc{idx}", nn.Linear(d, embed_dims))
                self.order.append(f"fc{idx}")
                d = embed_dims
                idx += 1
            self.add_module(f"ln{idx - 1}", nn.LayerNorm(embed_dims,
                                                         eps=LN_EPS))
            self.order.append(f"ln{idx - 1}")

    def forward(self, x):
        for name in self.order:
            x = getattr(self, name)(x)
            if name.startswith("fc"):
                x = torch.relu(x)
        return x


class Scale(nn.Module):
    """Per-channel learnable scale."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


def masked_softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax with exact zeros for fully masked (-inf) rows."""
    m = logits.amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    unnorm = torch.exp(logits - m)
    unnorm = torch.where(torch.isfinite(logits), unnorm,
                         torch.zeros_like(unnorm))
    denom = unnorm.sum(dim=dim, keepdim=True)
    return unnorm / torch.clamp(denom, min=1e-30)


class MultiheadAttention(nn.Module):
    """Torch-semantics multi-head attention with separate q/k/v/out
    projections; `attn_mask` is bool (True = blocked) or additive,
    [L, S] or [bs, L, S]. Fully masked rows give zeros."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dims, embed_dims)
        self.k_proj = nn.Linear(embed_dims, embed_dims)
        self.v_proj = nn.Linear(embed_dims, embed_dims)
        self.out_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, key=None, value=None, attn_mask=None):
        if key is None:
            key = query
        if value is None:
            value = key
        e, h = self.embed_dims, self.num_heads
        hd = e // h
        bs, L = query.shape[:2]
        S = key.shape[1]
        q = self.q_proj(query).reshape(bs, L, h, hd).transpose(1, 2)
        k = self.k_proj(key).reshape(bs, S, h, hd).transpose(1, 2)
        v = self.v_proj(value).reshape(bs, S, h, hd).transpose(1, 2)
        logits = torch.einsum("bhld,bhsd->bhls", q, k) / math.sqrt(hd)
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                bias = torch.zeros(attn_mask.shape, dtype=q.dtype,
                                   device=q.device)
                bias = bias.masked_fill(attn_mask, float("-inf"))
            else:
                bias = attn_mask.to(q.dtype)
            if bias.dim() == 2:
                bias = bias[None, None]
            elif bias.dim() == 3:
                bias = bias[:, None]
            logits = logits + bias
        probs = masked_softmax(logits, dim=-1)
        out = torch.einsum("bhls,bhsd->bhld", probs, v)
        return self.out_proj(out.transpose(1, 2).reshape(bs, L, e))


class ResidualAttention(nn.Module):
    """`identity + attn(q + pos, k + pos, v)` (mmcv MultiheadAttention
    wrapper; dropouts are inference no-ops)."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.attn = MultiheadAttention(embed_dims, num_heads)

    def forward(self, query, key=None, value=None, query_pos=None,
                key_pos=None, attn_mask=None, identity=None):
        if key is None:
            key = query
        if value is None:
            value = key
        if identity is None:
            identity = query
        if key_pos is None and query_pos is not None and (
            query_pos.shape == key.shape
        ):
            key_pos = query_pos
        q = query + query_pos if query_pos is not None else query
        k = key + key_pos if key_pos is not None else key
        return identity + self.attn(q, k, value, attn_mask=attn_mask)


class AsymmetricFFN(nn.Module):
    """FFN with a 2x-wide input after `residual_mode='cat'` ops:
    pre-LayerNorm, fc1 -> ReLU -> fc2, plus a projected identity."""

    def __init__(self, embed_dims: int = 256, in_channels: int = 512,
                 feedforward_channels: int = 1024):
        super().__init__()
        self.pre_norm = nn.LayerNorm(in_channels, eps=LN_EPS)
        self.fc1 = nn.Linear(in_channels, feedforward_channels)
        self.fc2 = nn.Linear(feedforward_channels, embed_dims)
        self.has_identity_fc = in_channels != embed_dims
        if self.has_identity_fc:
            self.identity_fc = nn.Linear(in_channels, embed_dims)

    def forward(self, x):
        x = self.pre_norm(x)
        out = self.fc2(torch.relu(self.fc1(x)))
        identity = self.identity_fc(x) if self.has_identity_fc else x
        return identity + out


def pos2posemb2d(pos: torch.Tensor, num_pos_feats: int = 128,
                 temperature: float = 10000.0) -> torch.Tensor:
    """Sine embedding of 2D points in (0, 1): [..., 2] -> [..., 2F],
    ordered (y, x)."""
    pos = pos * (2 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)
    px = pos[..., 0, None] / dim_t
    py = pos[..., 1, None] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()], -1).flatten(-2)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()], -1).flatten(-2)
    return torch.cat([py, px], dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))
