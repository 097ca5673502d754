"""Per-camera query-group attention, 2D branch
(port of `simpb_tpu/models/group_attn.py`).

* `QueryGroupSelfAttention` — attention within each camera's K slots,
  cameras folded into the batch; padded slots are masked as keys.
* `QueryGroupMSDA` — per-camera windowed multi-scale deformable
  cross-attention on the serving path of the JAX package: patch mode
  with top-k level selection and valid-slot compaction, sampling the
  RAW feature column and applying the value projection to the sampled
  rows afterwards, with the `(wsum - 1) * bias` border correction
  (the order the JAX serving head computes in).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.format import SpatialShapes
from ..ops.sampling import msda_patch, topk_stable
from .layers import MultiheadAttention


class QueryGroupSelfAttention(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int = 8,
                 num_cams: int = 6):
        super().__init__()
        self.num_cams = num_cams
        self.attn = MultiheadAttention(embed_dims, num_heads)

    def forward(self, query, value, valid, identity=None):
        """query/value [bs, cams*K, E], valid [bs, cams*K] bool."""
        bs, q_total, e = query.shape
        k = q_total // self.num_cams
        fold = lambda x: x.reshape((bs * self.num_cams, k) + x.shape[2:])
        q = fold(query)
        key_mask = fold(valid)
        bias = torch.zeros(key_mask.shape, dtype=q.dtype, device=q.device)
        bias = bias.masked_fill(~key_mask, float("-inf"))[:, None, :]
        out = self.attn(q, q, fold(value), attn_mask=bias)
        base = query if identity is None else identity
        return base + out.reshape(bs, q_total, e)


def msda_offset_bias_init(num_heads: int, num_levels: int,
                          num_points: int) -> np.ndarray:
    """Grid-direction bias init for sampling offsets (mmcv MSDA init)."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * np.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class QueryGroupMSDA(nn.Module):
    """Per-camera windowed MSDA for 2D queries, residual_mode='cat'.
    Slots without an allocated depth get zero locations (the padded
    slots), and with `gather_capacity` only the first `cap` valid slots
    of each camera are sampled."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 num_cams: int = 6, gather_capacity: Optional[int] = None,
                 sel_levels: Optional[int] = None,
                 patch_hw: Tuple[int, int] = (8, 8)):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.num_cams = num_cams
        self.gather_capacity = gather_capacity
        self.sel_levels = sel_levels
        self.patch_hw = tuple(patch_hw)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.sampling_offsets = nn.Linear(
            embed_dims, num_heads * num_levels * num_points * 2
        )
        self.attention_weights = nn.Linear(
            embed_dims, num_heads * num_levels * num_points
        )
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                msda_offset_bias_init(num_heads, num_levels, num_points)
            ))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def _project(self, sampled, wsum):
        """Per-head value projection of raw samples plus the weight-mass
        bias correction: channel d of head h(d) becomes
        (Σ w_h x) . W[:, d] + wsum_h * b[d]."""
        heads, e = self.num_heads, self.embed_dims
        head_mask = torch.repeat_interleave(
            torch.eye(heads, device=sampled.device), e // heads, dim=1
        )
        proj = self.value_proj(sampled.to(self.value_proj.weight.dtype))
        out = torch.einsum("bmhc,hc->bmc", proj.float(), head_mask)
        corr = torch.einsum("bmh,hc->bmc", wsum - 1.0, head_mask)
        return out + corr * self.value_proj.bias.float()

    def forward(self, query, query_pos, reference_points, ref_depth,
                value: torch.Tensor, spatial_shapes: SpatialShapes):
        """query/query_pos [bs, cams*K, C], reference_points [bs, cams*K,
        2], ref_depth [bs, cams*K, 1], value [bs, cams, ΣHW, C] (raw
        features). Returns [bs, cams*K, 2C]."""
        bs, q_total, _ = query.shape
        heads, levels, points = (self.num_heads, self.num_levels,
                                 self.num_points)
        k = q_total // self.num_cams
        b2 = bs * self.num_cams
        identity = query
        if query_pos is not None:
            query = query + query_pos
        v = value.reshape(b2, -1, self.embed_dims)
        offsets = self.sampling_offsets(query).reshape(
            bs, q_total, heads, levels, points, 2
        )
        attn = torch.softmax(
            self.attention_weights(query).reshape(
                bs, q_total, heads, levels * points
            ), dim=-1,
        ).reshape(bs, q_total, heads, levels, points)
        normalizer = torch.tensor(
            [(w_, h_) for h_, w_ in spatial_shapes.shapes],
            dtype=offsets.dtype, device=offsets.device,
        )
        loc = (reference_points[:, :, None, None, None, :]
               + offsets / normalizer[None, None, None, :, None, :])
        loc = torch.where(ref_depth[:, :, None, None, None, :] > 0, loc,
                          torch.zeros_like(loc))
        loc = loc.reshape(b2, k, heads, levels, points, 2)
        w = attn.reshape(b2, k, heads, levels, points)

        def sample(loc_, w_):
            sampled, wsum = msda_patch(
                v, spatial_shapes, loc_, w_, patch_h=self.patch_hw[0],
                patch_w=self.patch_hw[1], sel_levels=self.sel_levels,
                raw_heads=True,
            )
            return self._project(sampled, wsum)

        cap = self.gather_capacity
        if cap is not None and cap < k:
            valid = (ref_depth[..., 0] > 0).reshape(b2, k)
            score = valid.float() * (2.0 * k) - torch.arange(
                k, dtype=torch.float32, device=valid.device
            )
            _, sel = topk_stable(score, cap)  # [b2, cap]
            take = lambda x: torch.gather(
                x, 1, sel.reshape(sel.shape + (1,) * (x.dim() - 2)).expand(
                    sel.shape + x.shape[2:])
            )
            sel_valid = torch.gather(valid, 1, sel)
            out_sel = sample(take(loc), take(w))  # [b2, cap, C]
            out = torch.zeros((b2, k, self.embed_dims), dtype=torch.float32,
                              device=out_sel.device)
            out.scatter_add_(
                1, sel[..., None].expand(out_sel.shape),
                out_sel * sel_valid[..., None].float(),
            )
        else:
            out = sample(loc, w)
        out = self.output_proj(out.reshape(bs, q_total, self.embed_dims))
        return torch.cat([out, identity], dim=-1)
