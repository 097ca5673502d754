"""Shared neural building blocks (port of `simpb_tpu/models/layers.py`).

Parameter names follow the JAX tree (`fc0`, `ln0`, `q_proj`, ...);
`utils/convert.py` maps a JAX Dense kernel [in, out] to a Linear weight
[out, in]. LayerNorm eps is 1e-5 everywhere.

Compute dtype, as flax's `dtype=`: parameters stay float32; `Dense`
casts its input and parameters to the module's dtype, `LayerNorm`
takes its statistics in float32 and returns the dtype, attention's
softmax runs in the dtype of its logits. Elsewhere the dtypes follow
type promotion, which in PyTorch matches JAX's except for a 0-dim
float32 tensor beside a bf16 one (JAX promotes to float32, PyTorch
keeps bf16); the head's modules hold no such pair.

Dropout (training only) draws from the generator that
`dropout_generator` installs for the length of a training forward; with
none installed, or a rate of 0, `dropout` is the identity (flax's
`deterministic=True`). `dropout_keep` is its one draw.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import batch_slice_draw

LN_EPS = 1e-5
_DROPOUT_GEN: contextvars.ContextVar = contextvars.ContextVar(
    "dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]):
    """Dropout draws from `generator` inside (None: no dropout)."""
    token = _DROPOUT_GEN.set(generator)
    try:
        yield
    finally:
        _DROPOUT_GEN.reset(token)


def current_dropout_generator() -> Optional[torch.Generator]:
    return _DROPOUT_GEN.get()


def dropout_keep(generator: torch.Generator, shape, keep_prob: float,
                 device) -> torch.Tensor:
    """Bernoulli(keep_prob) keep mask (uniform < keep_prob, as
    `jax.random.bernoulli`). The leading axis is the local batch
    (batch-major: [bs, ...] or [bs * cams, ...]); under a process group
    the mask is this rank's rows of the global batch's
    (`batch_slice_draw`)."""
    return batch_slice_draw(
        lambda s: torch.rand(s, generator=generator, device=device),
        shape) < keep_prob


def dropout(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout at `rate` with the installed generator."""
    gen = _DROPOUT_GEN.get()
    if rate <= 0.0 or gen is None:
        return x
    keep = dropout_keep(gen, x.shape, 1.0 - rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t.to(dtype)`, skipped where t has the type already (the same
    tensor either way; `torch.export` records a `.to` that casts
    nothing as two graph nodes)."""
    return t if t.dtype == dtype else t.to(dtype)


class Dense(nn.Linear):
    """`nn.Linear` computing in `dtype` (flax `nn.Dense(dtype=...)`): the
    input, weight and bias are cast to it, and the product is rounded to
    it before the bias is added, as flax adds the bias after its
    product (one fused `addmm` rounds once, an ulp off now and then in
    bf16)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        y = F.linear(cast(x, self.dtype), cast(self.weight, self.dtype))
        return y if self.bias is None else y + cast(self.bias, self.dtype)


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` returning `dtype` (flax `nn.LayerNorm(dtype=...)`):
    statistics and normalisation in float32, then one cast."""

    def __init__(self, dims: int, dtype: torch.dtype = torch.float32):
        super().__init__(dims, eps=LN_EPS)
        self.dtype = dtype

    def forward(self, x):
        return cast(super().forward(cast(x, torch.float32)), self.dtype)


class MLPStack(nn.Module):
    """`linear_relu_ln(embed, in_loops, out_loops)`: out_loops x
    [in_loops x (Linear, ReLU), LayerNorm], in `dtype`."""

    def __init__(self, in_dims: int, embed_dims: int, in_loops: int = 1,
                 out_loops: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.order = []
        idx = 0
        d = in_dims
        for _ in range(out_loops):
            for _ in range(in_loops):
                self.add_module(f"fc{idx}", Dense(d, embed_dims,
                                                  dtype=dtype))
                self.order.append(f"fc{idx}")
                d = embed_dims
                idx += 1
            self.add_module(f"ln{idx - 1}", LayerNorm(embed_dims, dtype))
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
        return x * cast(self.scale, x.dtype)


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
    projections, in `dtype`; `attn_mask` is bool (True = blocked) or
    additive, [L, S] or [bs, L, S]. Fully masked rows give zeros."""

    def __init__(self, embed_dims: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 attn_drop: float = 0.0):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        # JAX divides by sqrt(head dim) taken in the compute dtype
        self.scale = float(torch.tensor(float(embed_dims // num_heads),
                                        dtype=dtype, device="cpu").sqrt())
        self.q_proj = Dense(embed_dims, embed_dims, dtype=dtype)
        self.k_proj = Dense(embed_dims, embed_dims, dtype=dtype)
        self.v_proj = Dense(embed_dims, embed_dims, dtype=dtype)
        self.out_proj = Dense(embed_dims, embed_dims, dtype=dtype)

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
        logits = torch.einsum("bhld,bhsd->bhls", q, k) / self.scale
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
        probs = dropout(masked_softmax(logits, dim=-1), self.attn_drop)
        out = torch.einsum("bhls,bhsd->bhld", probs, v)
        return self.out_proj(out.transpose(1, 2).reshape(bs, L, e))


class ResidualAttention(nn.Module):
    """`identity + dropout(attn(q + pos, k + pos, v))` (mmcv
    MultiheadAttention wrapper: `drop` is both the attention-prob and the
    output dropout)."""

    def __init__(self, embed_dims: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, drop: float = 0.0):
        super().__init__()
        self.out_drop = drop
        self.attn = MultiheadAttention(embed_dims, num_heads, dtype, drop)

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
        return identity + dropout(self.attn(q, k, value, attn_mask=attn_mask),
                                  self.out_drop)


class AsymmetricFFN(nn.Module):
    """FFN with a 2x-wide input after `residual_mode='cat'` ops:
    pre-LayerNorm, fc1 -> ReLU -> fc2, plus a projected identity."""

    def __init__(self, embed_dims: int = 256, in_channels: int = 512,
                 feedforward_channels: int = 1024,
                 dtype: torch.dtype = torch.float32, ffn_drop: float = 0.0):
        super().__init__()
        self.ffn_drop = ffn_drop
        self.pre_norm = LayerNorm(in_channels, dtype)
        self.fc1 = Dense(in_channels, feedforward_channels, dtype=dtype)
        self.fc2 = Dense(feedforward_channels, embed_dims, dtype=dtype)
        self.has_identity_fc = in_channels != embed_dims
        if self.has_identity_fc:
            self.identity_fc = Dense(in_channels, embed_dims, dtype=dtype)

    def forward(self, x):
        x = self.pre_norm(x)
        out = dropout(torch.relu(self.fc1(x)), self.ffn_drop)
        out = dropout(self.fc2(out), self.ffn_drop)
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
