"""Per-camera query-group attention, 2D branch
(port of `simpb_tpu/models/group_attn.py`).

* `QueryGroupSelfAttention` — attention within each camera's K slots,
  cameras folded into the batch; padded slots are masked as keys.
* `QueryGroupMSDA` — per-camera multi-scale deformable cross-attention
  on the serving path of the JAX package: windowed (`patch_mode`, with
  top-k level selection) or exact (`msda`), with valid-slot compaction,
  sampling the RAW feature column and applying the value projection to
  the sampled rows afterwards, with the `(wsum - 1) * bias` border
  correction (the order the JAX serving head computes in). In training
  (`project_first`, windowed or exact) the value projection runs on the
  feature column before sampling, as the JAX training head computes it
  (JAX's head passes no pair table in training).
  With a `guards` collector it records the guard counters JAX sows
  (`utils/guards.py`). The hybrid mode is not ported.

Both compute in `dtype`. In bf16 the offsets and attention weights come
out of bf16 layers; the locations are float32 (float32 reference points
plus bf16 offsets), and the weights are cast to float32 before the
sampling op, which JAX's op does inside itself: exact.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.format import SpatialShapes
from ..ops.sampling import msda, msda_patch, msda_window_stats, topk_stable
from .layers import Dense, MultiheadAttention, dropout


class QueryGroupSelfAttention(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int = 8,
                 num_cams: int = 6, dtype: torch.dtype = torch.float32,
                 attn_drop: float = 0.0, out_drop: float = 0.0):
        super().__init__()
        self.num_cams = num_cams
        self.out_drop = out_drop
        self.attn = MultiheadAttention(embed_dims, num_heads, dtype,
                                       attn_drop)

    def forward(self, query, value, valid, identity=None):
        """query/value [bs, cams*K, E], valid [bs, cams*K] bool."""
        bs, q_total, e = query.shape
        k = q_total // self.num_cams
        fold = lambda x: x.reshape((bs * self.num_cams, k) + x.shape[2:])
        q = fold(query)
        key_mask = fold(valid)
        bias = torch.zeros(key_mask.shape, dtype=q.dtype, device=q.device)
        bias = bias.masked_fill(~key_mask, float("-inf"))[:, None, :]
        out = dropout(self.attn(q, q, fold(value), attn_mask=bias),
                      self.out_drop)
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
    """Per-camera MSDA for 2D queries, residual_mode='cat': windowed with
    `patch_mode` (the default here; JAX's default is exact), else exact.
    Slots without an allocated depth get zero locations (the padded
    slots), and with `gather_capacity` only the first `cap` valid slots
    of each camera are sampled."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 num_cams: int = 6, gather_capacity: Optional[int] = None,
                 sel_levels: Optional[int] = None,
                 patch_hw: Tuple[int, int] = (8, 8),
                 dtype: torch.dtype = torch.float32, drop: float = 0.0,
                 patch_mode: bool = True):
        super().__init__()
        self.drop = drop
        self.patch_mode = patch_mode
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.num_cams = num_cams
        self.gather_capacity = gather_capacity
        self.sel_levels = sel_levels
        self.patch_hw = tuple(patch_hw)
        self.value_proj = Dense(embed_dims, embed_dims, dtype=dtype)
        self.sampling_offsets = Dense(
            embed_dims, num_heads * num_levels * num_points * 2, dtype=dtype
        )
        self.attention_weights = Dense(
            embed_dims, num_heads * num_levels * num_points, dtype=dtype
        )
        self.output_proj = Dense(embed_dims, embed_dims, dtype=dtype)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                msda_offset_bias_init(num_heads, num_levels, num_points)
            ))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def _guards(self, guards, loc, attn, ref_depth, spatial_shapes, cap):
        """The counters JAX's layer sows, on the device: `msda_overflow`
        (the most valid slots of a camera beyond the capacity) and, when
        windowed, the window and level-selection counters of
        `msda_window_stats`."""
        bs, q_total = ref_depth.shape[:2]
        k = q_total // self.num_cams
        valid = ref_depth[..., 0] > 0  # [bs, cams*K]
        counts = valid.reshape(bs * self.num_cams, k).sum(-1)
        cap_eff = cap if cap is not None and cap < k else k
        add = lambda name, v: guards.setdefault(name, []).append(v)
        add("msda_overflow", (counts.max() - cap_eff).clamp(min=0).float())
        if self.patch_mode:
            stats = msda_window_stats(
                spatial_shapes, loc, attn, self.patch_hw[0],
                self.patch_hw[1], sel_levels=self.sel_levels, valid=valid)
            add("msda_window_clamped", stats["window_clamped"].sum())
            add("msda_window_clamped_mass",
                stats["window_clamped_mass"].sum())
            add("msda_level_dropped_mass",
                stats["level_dropped_mass"].max())

    def _project(self, sampled, wsum):
        """Per-head value projection of raw samples plus the weight-mass
        bias correction: channel d of head h(d) becomes
        (Σ w_h x) . W[:, d] + wsum_h * b[d], with b as the projection
        adds it (rounded to the compute dtype)."""
        heads, e = self.num_heads, self.embed_dims
        head_mask = torch.repeat_interleave(
            torch.eye(heads, device=sampled.device), e // heads, dim=1
        )
        proj = self.value_proj(sampled)
        out = torch.einsum("bmhc,hc->bmc", proj.float(), head_mask)
        corr = torch.einsum("bmh,hc->bmc", wsum - 1.0, head_mask)
        bias = self.value_proj.bias.to(self.value_proj.dtype).float()
        return out + corr * bias

    def forward(self, query, query_pos, reference_points, ref_depth,
                value: torch.Tensor, spatial_shapes: SpatialShapes,
                project_first: bool = False,
                capacity_override: Optional[int] = None,
                guards: Optional[dict] = None):
        """query/query_pos [bs, cams*K, C], reference_points [bs, cams*K,
        2], ref_depth [bs, cams*K, 1], value [bs, cams, ΣHW, C] (raw
        features). Returns [bs, cams*K, 2C]. `project_first` projects the
        value column before sampling (the training order);
        `capacity_override` replaces `gather_capacity`; `guards`, a
        collector dict, gets this call's guard counters appended."""
        bs, q_total, _ = query.shape
        heads, levels, points = (self.num_heads, self.num_levels,
                                 self.num_points)
        k = q_total // self.num_cams
        b2 = bs * self.num_cams
        identity = query
        if query_pos is not None:
            query = query + query_pos
        if project_first:
            v = self.value_proj(value).to(value.dtype).reshape(
                b2, -1, self.embed_dims)
        else:
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
        cap = (capacity_override if capacity_override is not None
               else self.gather_capacity)
        if guards is not None:
            self._guards(guards, loc, attn, ref_depth, spatial_shapes, cap)
        loc = loc.reshape(b2, k, heads, levels, points, 2)
        w = attn.reshape(b2, k, heads, levels, points).float()

        def sample(loc_, w_):
            if not self.patch_mode:
                if project_first:
                    return msda(v, spatial_shapes, loc_, w_)
                return self._project(*msda(v, spatial_shapes, loc_, w_,
                                           raw_heads=True))
            if project_first:
                return msda_patch(
                    v, spatial_shapes, loc_, w_, patch_h=self.patch_hw[0],
                    patch_w=self.patch_hw[1], sel_levels=self.sel_levels,
                )
            sampled, wsum = msda_patch(
                v, spatial_shapes, loc_, w_, patch_h=self.patch_hw[0],
                patch_w=self.patch_hw[1], sel_levels=self.sel_levels,
                raw_heads=True,
            )
            return self._project(sampled, wsum)

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
        out = dropout(self.output_proj(
            out.reshape(bs, q_total, self.embed_dims)), self.drop)
        return torch.cat([out, identity], dim=-1)
