"""SimPB head: the interleaved 2D/3D decoder driven by `operation_order`
(port of `simpb_tpu/models/head.py`).

The decoder is a program over named ops (allocation / qg_self_attn /
qg_cross_attn / refine2d / aggregation / gnn / temp_gnn / deformable /
refine3d / ffn / norm). Each op's module is registered as
`op{i}_{name}`, the JAX tree's names. Decoupled attention
(`decouple_attn`, `decouple_attn2d`, on in every released
configuration) concatenates query and positional embedding and shares
the fc_before / fc_after projections; off, the attention runs at the
embedding width with the positional embedding added to query and key,
and no projection around it (JAX's identities). With `encoder2d_layers`
(off in every released configuration) a deformable encoder
(`models/encoder2d.py`) refines the feature column once a frame, and
the 2D cross-attention samples its memory (DFA too under
`share_encoder2d`).

Training (`train=True`) runs the JAX training program: the denoising
(DN) anchors of a `DnBundle` join the queries behind an attention mask
that keeps the groups apart, get 2D slots of their own (allocated by
GT visibility), are refined by every layer, re-injected from the cached
`DnState` after the single-frame decoders (`update_dn`) and split off
into the `dn_*` outputs; every refine3d reports classes; the MSDA value
projection runs before sampling; dropout draws from the installed
generator; `sampling` (a generator) ranks corner-only allocations at
random and caches DN groups for the next frame. No instance ids are
assigned under training.

Serving under `guard_sampling` fills a collector, {counter name: [a value
a layer]}, from the DFA and MSDA layers (the counters JAX sows into its
"guards" collection) and returns it as `guards`; the values stay on the
device (`utils/guards.py` reduces them).

The head computes in `dtype` (float32, or bfloat16 as `head_dtype`
sets it); its parameters, the anchors and the carried temporal state
stay float32, as in the JAX head.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from ..configs.base import HeadConfig
from ..ops.format import SpatialShapes
from ..training.dn import DnState, cache_dn, update_dn
from ..training.targets3d import DnBundle
from .aggregation import ReWeight
from .allocation import Allocation, allocate_queries, dispatch_to_2d
from .det2d_blocks import SparseBox2DEncoder, SparseBox2DRefinementModule
from .det3d_blocks import SparseBox3DEncoder, SparseBox3DRefinementModule
from .dfa import DeformableFeatureAggregation
from .encoder2d import DeformableEncoder2D
from .group_attn import QueryGroupMSDA, QueryGroupSelfAttention
from .instance_bank import InstanceBank, TemporalState
from .layers import AsymmetricFFN, Dense, LayerNorm, ResidualAttention


def check_head_config(c: HeadConfig) -> None:
    """The knobs of the serving path this port covers so far."""
    unsupported = {
        "dfa_sel_levels": bool(c.dfa_sel_levels),
        "dfa_level_capacity": bool(c.dfa_level_capacity),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"head settings not ported yet: {bad} (see ROADMAP.md)"
        )


def gather_dn_slot_targets(alloc: Allocation, bundle: DnBundle,
                           num_cams: int):
    """Per-slot DN 2D targets from the bundle's per-(instance, camera)
    GT, gathered through each slot's (parent instance, camera)."""
    bs, q = alloc.parent_idx.shape
    k = q // num_cams
    dev = alloc.parent_idx.device
    cam_idx = torch.arange(num_cams, device=dev).repeat_interleave(k)[
        None].expand(bs, q)
    b_idx = torch.arange(bs, device=dev)[:, None].expand(bs, q)
    pick = lambda x: x[b_idx, alloc.parent_idx, cam_idx]
    valid = alloc.valid
    return {
        "cls": torch.where(valid, pick(bundle.cls_target2d),
                           torch.full_like(pick(bundle.cls_target2d), -1)),
        "box": torch.where(valid[..., None], pick(bundle.box_target2d),
                           torch.zeros_like(pick(bundle.box_target2d))),
        "alpha": torch.where(valid, pick(bundle.alpha_target2d),
                             torch.zeros_like(pick(bundle.alpha_target2d))),
        "valid": valid & pick(bundle.valid_mask2d),
    }


class SimPBHead(nn.Module):
    """`train=True` builds the classification and quality branches of
    every refine3d layer (the training tree); serving builds them only
    where inference reads them."""

    def __init__(self, cfg: HeadConfig, dtype: torch.dtype = torch.float32,
                 train: bool = False):
        super().__init__()
        check_head_config(cfg)
        self.cfg = c = cfg
        e = c.embed_dims
        self.bank = InstanceBank(
            num_anchor=c.num_anchor,
            num_temp_instances=c.num_temp_instances,
            embed_dims=e,
            confidence_decay=c.confidence_decay,
            default_time_interval=c.default_time_interval,
            max_time_interval=c.max_time_interval,
        )
        self.anchor = nn.Parameter(torch.rand(c.num_anchor, 11))
        self.instance_feature = nn.Parameter(
            torch.zeros(c.num_anchor, e), requires_grad=False
        )
        self.anchor_encoder = SparseBox3DEncoder(
            (e // 2, e // 8, e // 8, e // 4), dtype=dtype)
        self.anchor_encoder2d = SparseBox2DEncoder(e, dtype)
        if c.encoder2d_layers:
            self.encoder2d = DeformableEncoder2D(
                e, c.num_groups, c.num_levels, 4, c.encoder2d_layers, 4 * e,
                c.drop_out, dtype)
        dense = lambda i, o: Dense(i, o, bias=False, dtype=dtype)
        if c.decouple_attn:
            self.fc_before = dense(e, 2 * e)
            self.fc_after = dense(2 * e, e)
        if c.decouple_attn2d:
            self.fc_before2d = dense(e, 2 * e)
            self.fc_after2d = dense(2 * e, e)
        attn_dims = 2 * e if c.decouple_attn else e
        attn2d_dims = 2 * e if c.decouple_attn2d else e

        order = c.operation_order
        self.op_names: List[Optional[str]] = []
        num_refine3d = 0
        for i, op in enumerate(order):
            if op == "ffn":
                mod = AsymmetricFFN(e, 2 * e, 4 * e, dtype, c.drop_out)
            elif op == "norm":
                mod = LayerNorm(e, dtype)
            elif op in ("gnn", "temp_gnn"):
                mod = ResidualAttention(attn_dims, c.num_groups, dtype,
                                        c.drop_out)
            elif op == "deformable":
                mod = DeformableFeatureAggregation(
                    e, c.num_groups, c.num_levels, c.num_cams,
                    c.num_learnable_pts, c.dfa_gather_capacity, dtype,
                    c.dfa_attn_drop,
                )
            elif op == "refine3d":
                # intermediate layers report no cls/quality at inference
                with_cls = (train
                            or num_refine3d == c.num_single_frame_decoder - 1
                            or i == len(order) - 1)
                num_refine3d += 1
                mod = SparseBox3DRefinementModule(
                    e, num_cls=c.num_classes, with_cls=with_cls,
                    with_quality_estimation=c.with_quality_estimation,
                    dtype=dtype,
                )
            elif op == "refine2d":
                mod = SparseBox2DRefinementModule(e, num_cls=c.num_classes,
                                                  dtype=dtype)
            elif op == "qg_self_attn":
                mod = QueryGroupSelfAttention(attn2d_dims, c.num_groups,
                                              c.num_cams, dtype, c.drop_out,
                                              0.1)
            elif op == "qg_cross_attn":
                mod = QueryGroupMSDA(
                    e, c.num_groups, c.num_levels, 4, c.num_cams,
                    gather_capacity=c.msda_gather_capacity,
                    sel_levels=c.msda_sel_levels or None,
                    patch_hw=c.msda_patch_hw, dtype=dtype, drop=c.drop_out,
                    patch_mode=c.msda_patch_mode,
                    hybrid_mode=c.msda_hybrid_mode,
                    clamp_capacity=c.msda_clamp_capacity,
                )
            elif op == "aggregation":
                self.add_module(f"op{i}_reweight", ReWeight(e, dtype))
                op = "aggregation_attn"
                mod = ResidualAttention(attn_dims, c.num_groups, dtype,
                                        c.drop_out)
            elif op == "allocation":
                self.op_names.append(None)
                continue
            else:
                raise NotImplementedError(op)
            name = f"op{i}_{op}"
            self.add_module(name, mod)
            self.op_names.append(name)

    def graph_model(self, layer, query, key=None, value=None,
                    query_pos=None, key_pos=None, attn_mask=None):
        """Decoupled attention: concat (query, pos) [and (key, pos)],
        value through fc_before, output through fc_after. Without
        `decouple_attn`, the layer adds the positions itself."""
        if not self.cfg.decouple_attn:
            return layer(query, key, value, query_pos=query_pos,
                         key_pos=key_pos, attn_mask=attn_mask)
        query = torch.cat([query, query_pos], dim=-1)
        if key is not None:
            key = torch.cat([key, key_pos], dim=-1)
        if value is not None:
            value = self.fc_before(value)
        return self.fc_after(layer(query, key, value, attn_mask=attn_mask))

    def forward(
        self,
        col_feats: torch.Tensor,  # [bs, cams, ΣHW, C]
        spatial_shapes: SpatialShapes,
        projection_mat: torch.Tensor,  # [bs, cams, 4, 4]
        image_wh: tuple,  # static (W, H)
        temporal: Optional[TemporalState] = None,
        time_interval: Optional[torch.Tensor] = None,  # [bs]
        temp2cur: Optional[torch.Tensor] = None,  # [bs, 4, 4]
        dn: Optional[DnBundle] = None,
        dn_state: Optional[DnState] = None,
        train: bool = False,
        sampling: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        c = self.cfg
        bs = col_feats.shape[0]
        dev = col_feats.device
        guards = {} if c.guard_sampling and not train else None
        image_wh_arr = torch.tensor(
            image_wh, dtype=torch.float32, device=dev
        )[None, None].expand(bs, c.num_cams, 2)

        (instance_feature, anchor, temp_instance_feature, temp_anchor,
         time_interval, temp_mask) = self.bank.get(
            self.anchor, self.instance_feature, bs, temporal, time_interval,
            temp2cur,
        )

        # denoising concat: DN rows attend within their group only
        attn_mask = None
        num_anchor3d = c.num_anchor
        dn_cur = dn  # the current targets; update_dn replaces them
        if dn is not None:
            num_dn = dn.dn_anchor.shape[1]
            anchor = torch.cat([anchor, dn.dn_anchor.to(anchor.dtype)], 1)
            instance_feature = torch.cat([instance_feature, torch.zeros(
                (bs, num_dn, instance_feature.shape[-1]),
                dtype=instance_feature.dtype, device=dev)], 1)
            n = num_anchor3d + num_dn
            attn_mask = torch.ones((n, n), dtype=torch.bool, device=dev)
            attn_mask[:num_anchor3d, :num_anchor3d] = False
            attn_mask[num_anchor3d:, num_anchor3d:] = dn.attn_mask

        anchor_embed = self.anchor_encoder(anchor)
        temp_anchor_embed = (self.anchor_encoder(temp_anchor)
                             if temp_anchor is not None else None)

        prediction, classification, quality = [], [], []
        prediction2d, classification2d, prediction_alpha2d = [], [], []
        alloc_list: List[Allocation] = []
        dn_slot_targets: List[dict] = []
        temp_attn_instance = instance_feature
        alloc: Optional[Allocation] = None
        dn2d: Optional[Allocation] = None
        anchor2d = anchor_embed2d = feat2d = None
        last = len(c.operation_order) - 1

        # the 2D cross-attention samples the encoder's memory; under
        # share_encoder2d so does DFA
        memory2d = col_feats
        if c.encoder2d_layers:
            memory2d = self.encoder2d(col_feats, spatial_shapes)
            if c.share_encoder2d:
                col_feats = memory2d

        for i, op in enumerate(c.operation_order):
            layer = (getattr(self, self.op_names[i])
                     if self.op_names[i] else None)
            if op in ("norm", "ffn"):
                if feat2d is not None:
                    feat2d = layer(feat2d)
                else:
                    instance_feature = layer(instance_feature)
            elif op == "allocation":
                alloc = allocate_queries(
                    anchor[:, :num_anchor3d], projection_mat, image_wh,
                    capacity=c.allocation_capacity,
                    limit_corners=c.limit_corners,
                    rng=sampling if train else None,
                )
                feat2d = dispatch_to_2d(alloc,
                                        instance_feature[:, :num_anchor3d])
                anchor2d = alloc.anchor2d
                if dn_cur is not None:
                    dn2d = allocate_queries(
                        anchor[:, num_anchor3d:], projection_mat, image_wh,
                        capacity=c.dn_allocation_capacity,
                        visibility=dn_cur.trans_mask2d,
                    )
                    feat2d = torch.cat([feat2d, dispatch_to_2d(
                        dn2d, instance_feature[:, num_anchor3d:])], 1)
                    anchor2d = torch.cat([anchor2d, dn2d.anchor2d], 1)
                anchor_embed2d = self.anchor_encoder2d(anchor2d)
            elif op == "qg_self_attn":
                feat2d = self._qg_self_attn(layer, feat2d, anchor_embed2d,
                                            alloc, dn2d)
            elif op == "qg_cross_attn":
                feat2d = self._qg_cross_attn(layer, feat2d, anchor_embed2d,
                                             alloc, dn2d, memory2d,
                                             spatial_shapes, train, guards)
            elif op == "refine2d":
                box2d, cls2d, alpha2d = layer(feat2d, anchor2d,
                                              anchor_embed2d)
                prediction2d.append(box2d)
                classification2d.append(cls2d)
                prediction_alpha2d.append(alpha2d)
                alloc_list.append(alloc)
                if dn2d is not None:
                    dn_slot_targets.append(
                        gather_dn_slot_targets(dn2d, dn_cur, c.num_cams))
                anchor2d = box2d
            elif op == "aggregation":
                instance_feature, anchor_embed = self._aggregate(
                    i, layer, feat2d, anchor_embed2d, alloc, dn2d,
                    temp_attn_instance, anchor_embed, attn_mask,
                )
                feat2d = None
                dn2d = None
            elif op == "gnn":
                instance_feature = self.graph_model(
                    layer, instance_feature, value=instance_feature,
                    query_pos=anchor_embed, attn_mask=attn_mask,
                )
            elif op == "temp_gnn":
                if temp_instance_feature is None:
                    # cold start: value = key = concat(query, pos), no
                    # fc_before (mmcv MultiheadAttention None-defaulting)
                    instance_feature = self.graph_model(
                        layer, instance_feature, query_pos=anchor_embed,
                        attn_mask=attn_mask,
                    )
                else:
                    instance_feature = self.graph_model(
                        layer, instance_feature, temp_instance_feature,
                        temp_instance_feature, query_pos=anchor_embed,
                        key_pos=temp_anchor_embed,
                    )
                temp_attn_instance = instance_feature
            elif op == "deformable":
                instance_feature = layer(
                    instance_feature, anchor, anchor_embed, col_feats,
                    spatial_shapes, projection_mat, image_wh_arr,
                    guards=guards,
                )
            elif op == "refine3d":
                return_cls = (
                    train
                    or len(prediction) == c.num_single_frame_decoder - 1
                    or i == last
                )
                anchor, cls, qt = layer(instance_feature, anchor,
                                        anchor_embed, time_interval,
                                        return_cls)
                prediction.append(anchor)
                classification.append(cls)
                quality.append(qt)
                if len(prediction) == c.num_single_frame_decoder:
                    if temporal is not None:
                        instance_feature, anchor = self.bank.update(
                            instance_feature, anchor, cls,
                            temp_instance_feature, temp_anchor, temp_mask,
                        )
                    if dn_cur is not None and c.num_temp_dn_groups > 0:
                        tvm = (temp_mask if temp_mask is not None else
                               torch.zeros((bs,), dtype=torch.bool,
                                           device=dev))
                        instance_feature, anchor, dn_cur = update_dn(
                            instance_feature, anchor, dn_cur, dn_state, tvm,
                            num_anchor3d, c.num_dn_groups,
                            c.num_temp_dn_groups,
                        )
                if i != last:
                    anchor_embed = self.anchor_encoder(anchor)
                if (len(prediction) > c.num_single_frame_decoder
                        and temp_anchor_embed is not None):
                    temp_anchor_embed = anchor_embed[:, : c.num_temp_instances]
            else:
                raise NotImplementedError(op)

        output: Dict[str, Any] = {}
        if dn is not None:
            a3 = num_anchor3d
            q2 = alloc_list[0].valid.shape[1] if alloc_list else 0
            output["dn_prediction"] = [p[:, a3:] for p in prediction]
            output["dn_classification"] = [
                x[:, a3:] if x is not None else None for x in classification]
            output["dn_prediction2d"] = [p[:, q2:] for p in prediction2d]
            output["dn_classification2d"] = [
                p[:, q2:] for p in classification2d]
            output["dn_prediction_alpha2d"] = [
                p[:, q2:] for p in prediction_alpha2d]
            output["dn_slot_targets"] = dn_slot_targets
            output["dn_bundle_first"] = dn
            output["dn_bundle_temp"] = dn_cur
            prediction = [p[:, :a3] for p in prediction]
            classification = [x[:, :a3] if x is not None else None
                              for x in classification]
            quality = [x[:, :a3] if x is not None else None for x in quality]
            prediction2d = [p[:, :q2] for p in prediction2d]
            classification2d = [p[:, :q2] for p in classification2d]
            prediction_alpha2d = [p[:, :q2] for p in prediction_alpha2d]
            dn_instance_feature = instance_feature[:, a3:]
            dn_anchor_final = anchor[:, a3:]
            instance_feature = instance_feature[:, :a3]
            anchor = anchor[:, :a3]
            # cache a random subset of DN groups for the next frame
            if c.num_temp_dn_groups > 0 and sampling is not None:
                output["dn_state"] = cache_dn(
                    sampling, dn_instance_feature, dn_anchor_final, dn_cur,
                    c.num_dn_groups, c.num_temp_dn_groups,
                )

        output.update(
            prediction=prediction,
            classification=classification,
            quality=quality,
            prediction2d=prediction2d,
            classification2d=classification2d,
            prediction_alpha2d=prediction_alpha2d,
            allocations=alloc_list,
        )
        cls_final = classification[-1]
        new_state, temp_confidence = self.bank.cache(
            instance_feature, anchor, cls_final, temporal, temp_mask
        )
        if not train:
            instance_id, new_state = self.bank.assign_instance_ids(
                cls_final, new_state, temp_confidence,
                threshold=c.score_threshold, temp_mask=temp_mask,
            )
            output["instance_id"] = instance_id
        output["temporal_state"] = new_state
        if guards is not None:
            output["guards"] = guards
        return output

    def _qg_self_attn(self, layer, feat2d, anchor_embed2d, alloc, dn2d):
        """Per-camera 2D self-attention; real and DN slots form separate
        camera blocks, so the layer runs once a block."""
        q2 = alloc.valid.shape[1]

        def run(query, pos, valid):
            if not self.cfg.decouple_attn2d:
                # the residual's identity is the query without positions
                return layer(query + pos, query, valid, identity=query)
            out = layer(torch.cat([query, pos], dim=-1),
                        self.fc_before2d(query), valid)
            return self.fc_after2d(out)

        real = run(feat2d[:, :q2], anchor_embed2d[:, :q2], alloc.valid)
        if dn2d is None:
            return real
        return torch.cat([real, run(feat2d[:, q2:], anchor_embed2d[:, q2:],
                                    dn2d.valid)], 1)

    def _qg_cross_attn(self, layer, feat2d, anchor_embed2d, alloc, dn2d,
                       col_feats, spatial_shapes, train, guards=None):
        """Per-camera MSDA; with DN each camera's real and DN slots both
        sample that camera (interleaved along the camera fold), with the
        slot capacity widened by the DN slots."""
        c = self.cfg
        if dn2d is None:
            return layer(feat2d, anchor_embed2d, alloc.anchor2d[..., :2],
                         alloc.ref_depth, col_feats, spatial_shapes,
                         project_first=train, guards=guards)
        q2 = alloc.valid.shape[1]
        bs = feat2d.shape[0]
        k, kd, cams = c.allocation_capacity, c.dn_allocation_capacity, \
            c.num_cams

        def interleave(real, dn):
            r = real.reshape((bs, cams, k) + tuple(real.shape[2:]))
            d = dn.reshape((bs, cams, kd) + tuple(dn.shape[2:]))
            return torch.cat([r, d], 2).reshape(
                (bs, cams * (k + kd)) + tuple(real.shape[2:]))

        merged = layer(
            interleave(feat2d[:, :q2], feat2d[:, q2:]),
            interleave(anchor_embed2d[:, :q2], anchor_embed2d[:, q2:]),
            interleave(alloc.anchor2d[..., :2], dn2d.anchor2d[..., :2]),
            interleave(alloc.ref_depth, dn2d.ref_depth),
            col_feats, spatial_shapes, project_first=train,
            capacity_override=(c.msda_gather_capacity + kd
                               if c.msda_gather_capacity is not None
                               else None),
        )
        m = merged.reshape((bs, cams, k + kd) + tuple(merged.shape[2:]))
        real = m[:, :, :k].reshape((bs, q2) + tuple(merged.shape[2:]))
        dn_out = m[:, :, k:].reshape((bs, cams * kd)
                                     + tuple(merged.shape[2:]))
        return torch.cat([real, dn_out], 1)

    def _aggregate(self, i, attn_layer, feat2d, anchor_embed2d, alloc, dn2d,
                   temp_attn_instance, anchor_embed, attn_mask):
        """Gate the 2D queries, average them back onto their 3D parents
        (DN slots onto the DN rows), add onto the pre-temporal 3D
        queries, then the decoupled self-attention."""
        reweight = getattr(self, f"op{i}_reweight")
        q2 = alloc.valid.shape[1]
        from2d, pos_from2d = reweight(
            feat2d[:, :q2], anchor_embed2d[:, :q2], alloc.trans_matrix,
            alloc.center_matrix,
        )
        if dn2d is not None:
            dn_from2d, dn_pos_from2d = reweight(
                feat2d[:, q2:], anchor_embed2d[:, q2:], dn2d.trans_matrix,
                dn2d.center_matrix,
            )
            from2d = torch.cat([from2d, dn_from2d], 1)
            pos_from2d = torch.cat([pos_from2d, dn_pos_from2d], 1)
        query3d = temp_attn_instance + from2d
        pos3d = anchor_embed + pos_from2d
        merged = self.graph_model(attn_layer, query3d, value=query3d,
                                  query_pos=pos3d, attn_mask=attn_mask)
        return merged, pos3d
