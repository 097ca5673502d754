"""Temporal instance memory as explicit state
(port of `simpb_tpu/models/instance_bank.py`).

`TemporalState` is threaded through the stream: `step(state, frame) ->
(outputs, state)`. The host provides each frame's `time_interval` and
the `temp2cur` ego-pose transform. Top-k selections use a stable sort,
so ties (every confidence is 0 at a cold start) keep the lower index
first, as `jax.lax.top_k` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core import box3d
from ..ops.sampling import topk_stable


@dataclasses.dataclass
class TemporalState:
    """Carried across frames; every field has a static shape."""

    feature: torch.Tensor  # [bs, T, C] cached instance features
    anchor: torch.Tensor  # [bs, T, 11] cached anchors
    confidence: torch.Tensor  # [bs, T] decayed sigmoid confidence
    instance_id: torch.Tensor  # [bs, A] tracking ids (-1 = none), int32
    prev_id: torch.Tensor  # [bs] next-free id counter, int32

    @staticmethod
    def init(bs: int, num_temp: int, num_anchor: int, embed_dims: int,
             device=None) -> "TemporalState":
        return TemporalState(
            feature=torch.zeros((bs, num_temp, embed_dims), device=device),
            anchor=torch.zeros((bs, num_temp, box3d.STATE_DIM),
                               device=device),
            confidence=torch.zeros((bs, num_temp), device=device),
            instance_id=torch.full((bs, num_anchor), -1, dtype=torch.int32,
                                   device=device),
            prev_id=torch.zeros((bs,), dtype=torch.int32, device=device),
        )

    def replace(self, **kw) -> "TemporalState":
        return dataclasses.replace(self, **kw)


def topk_gather(confidence: torch.Tensor, k: int, *inputs):
    """Batched top-k by confidence along axis 1, gathering companions."""
    conf, idx = topk_stable(confidence, k)
    outs = [
        torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                     .expand(idx.shape + x.shape[2:]))
        for x in inputs
    ]
    return conf, outs


class InstanceBank:
    """The bank's state transitions (get / update / cache / ids); the
    learnable anchors and features live in the head."""

    def __init__(self, num_anchor: int = 900, num_temp_instances: int = 600,
                 embed_dims: int = 256, confidence_decay: float = 0.6,
                 default_time_interval: float = 0.5,
                 max_time_interval: float = 2.0):
        self.num_anchor = num_anchor
        self.num_temp_instances = num_temp_instances
        self.embed_dims = embed_dims
        self.confidence_decay = confidence_decay
        self.default_time_interval = default_time_interval
        self.max_time_interval = max_time_interval

    def get(self, anchor_param, feature_param, batch_size: int,
            state: Optional[TemporalState], time_interval=None,
            temp2cur=None):
        """Start-of-frame fetch -> (instance_feature, anchor, temp_feature,
        temp_anchor, time_interval, temp_mask); temp_* are None at a cold
        start. Cached anchors are ego-motion compensated over -dt."""
        instance_feature = feature_param[None].expand(
            batch_size, -1, -1).contiguous()
        anchor = anchor_param[None].expand(batch_size, -1, -1).contiguous()
        dev = anchor_param.device
        if state is None:
            dt = torch.full((batch_size,), self.default_time_interval,
                            dtype=torch.float32, device=dev)
            return instance_feature, anchor, None, None, dt, None
        mask = time_interval.abs() <= self.max_time_interval
        temp_anchor = box3d.anchor_projection(
            state.anchor, temp2cur, -time_interval
        )
        dt = torch.where(
            (time_interval != 0) & mask, time_interval,
            torch.full_like(time_interval, self.default_time_interval),
        )
        return instance_feature, anchor, state.feature, temp_anchor, dt, mask

    def update(self, instance_feature, anchor, confidence_logits,
               temp_feature, temp_anchor, temp_mask):
        """Merge the fresh top-(A-T) instances with the cached T."""
        n = self.num_anchor - self.num_temp_instances
        conf = confidence_logits.amax(dim=-1)
        _, (sel_feature, sel_anchor) = topk_gather(
            conf, n, instance_feature, anchor
        )
        sel_feature = torch.cat([temp_feature, sel_feature], dim=1)
        sel_anchor = torch.cat([temp_anchor, sel_anchor], dim=1)
        m = temp_mask[:, None, None]
        return (torch.where(m, sel_feature, instance_feature),
                torch.where(m, sel_anchor, anchor))

    def cache(self, instance_feature, anchor, confidence_logits,
              state: Optional[TemporalState], temp_mask=None,
              ) -> Tuple[TemporalState, torch.Tensor]:
        """End-of-frame top-T cache with confidence decay -> (new_state,
        temp_confidence)."""
        instance_feature = instance_feature.detach().float()
        anchor = anchor.detach().float()
        conf = torch.sigmoid(confidence_logits.detach().amax(dim=-1)).float()
        t = self.num_temp_instances
        if state is not None:
            decayed = torch.maximum(state.confidence * self.confidence_decay,
                                    conf[:, :t])
            if temp_mask is not None:
                decayed = torch.where(temp_mask[:, None], decayed,
                                      conf[:, :t])
            conf = torch.cat([decayed, conf[:, t:]], dim=1)
        new_conf, (new_feature, new_anchor) = topk_gather(
            conf, t, instance_feature, anchor
        )
        prev = state if state is not None else TemporalState.init(
            instance_feature.shape[0], t, self.num_anchor, self.embed_dims,
            device=instance_feature.device,
        )
        return prev.replace(feature=new_feature, anchor=new_anchor,
                            confidence=new_conf), conf

    def assign_instance_ids(self, confidence_logits, state: TemporalState,
                            temp_confidence, threshold=None, temp_mask=None):
        """Tracking ids: current instances inherit stored ids, confident
        new ones get fresh sequential ids, and the id table follows the
        cached top-T. Returns (instance_id [bs, A], updated state)."""
        conf = torch.sigmoid(confidence_logits.amax(dim=-1))
        instance_id = state.instance_id.expand(conf.shape).to(torch.int32)
        if temp_mask is not None:
            instance_id = torch.where(temp_mask[:, None], instance_id,
                                      torch.full_like(instance_id, -1))
        new_mask = instance_id < 0
        if threshold is not None:
            new_mask = new_mask & (conf >= threshold)
        offsets = torch.cumsum(new_mask.to(torch.int32), dim=1) - 1
        fresh = (state.prev_id[:, None] + offsets).to(torch.int32)
        instance_id = torch.where(new_mask, fresh, instance_id)
        prev_id = (state.prev_id + new_mask.sum(dim=1)).to(torch.int32)
        _, (kept,) = topk_gather(temp_confidence, self.num_temp_instances,
                                 instance_id[..., None])
        kept = kept[..., 0].to(torch.int32)
        stored = torch.cat([
            kept,
            torch.full((kept.shape[0],
                        self.num_anchor - self.num_temp_instances), -1,
                       dtype=torch.int32, device=kept.device),
        ], dim=1)
        return instance_id, state.replace(instance_id=stored,
                                          prev_id=prev_id)
