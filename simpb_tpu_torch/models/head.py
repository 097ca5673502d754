"""SimPB head: the interleaved 2D/3D decoder driven by `operation_order`
(port of the inference program of `simpb_tpu/models/head.py`).

The decoder is a program over named ops (allocation / qg_self_attn /
qg_cross_attn / refine2d / aggregation / gnn / temp_gnn / deformable /
refine3d / ffn / norm). Each op's module is registered as
`op{i}_{name}`, the JAX tree's names. Decoupled attention concatenates
query and positional embedding and shares the fc_before / fc_after
projections. Denoising and the 2D feature encoder (`encoder2d`, off in
every released configuration) are not part of the serving path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from ..configs.base import HeadConfig
from ..ops.format import SpatialShapes
from .aggregation import ReWeight
from .allocation import Allocation, allocate_queries, dispatch_to_2d
from .det2d_blocks import SparseBox2DEncoder, SparseBox2DRefinementModule
from .det3d_blocks import SparseBox3DEncoder, SparseBox3DRefinementModule
from .dfa import DeformableFeatureAggregation
from .group_attn import QueryGroupMSDA, QueryGroupSelfAttention
from .instance_bank import InstanceBank, TemporalState
from .layers import LN_EPS, AsymmetricFFN, ResidualAttention


def _check_serving_config(c: HeadConfig) -> None:
    """The knobs of the serving path this port covers so far."""
    unsupported = {
        "decouple_attn": not c.decouple_attn,
        "decouple_attn2d": not c.decouple_attn2d,
        "msda_patch_mode": not c.msda_patch_mode,
        "msda_hybrid_mode": c.msda_hybrid_mode,
        "dfa_sel_levels": bool(c.dfa_sel_levels),
        "dfa_level_capacity": bool(c.dfa_level_capacity),
        "guard_sampling": c.guard_sampling,
        "encoder2d_layers": bool(c.encoder2d_layers),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"head settings not ported yet: {bad} (see ROADMAP.md)"
        )


class SimPBHead(nn.Module):
    def __init__(self, cfg: HeadConfig):
        super().__init__()
        _check_serving_config(cfg)
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
        self.anchor_encoder = SparseBox3DEncoder((e // 2, e // 8, e // 8,
                                                  e // 4))
        self.anchor_encoder2d = SparseBox2DEncoder(e)
        self.fc_before = nn.Linear(e, 2 * e, bias=False)
        self.fc_after = nn.Linear(2 * e, e, bias=False)
        self.fc_before2d = nn.Linear(e, 2 * e, bias=False)
        self.fc_after2d = nn.Linear(2 * e, e, bias=False)

        order = c.operation_order
        self.op_names: List[Optional[str]] = []
        num_refine3d = 0
        for i, op in enumerate(order):
            if op == "ffn":
                mod = AsymmetricFFN(e, 2 * e, 4 * e)
            elif op == "norm":
                mod = nn.LayerNorm(e, eps=LN_EPS)
            elif op in ("gnn", "temp_gnn"):
                mod = ResidualAttention(2 * e, c.num_groups)
            elif op == "deformable":
                mod = DeformableFeatureAggregation(
                    e, c.num_groups, c.num_levels, c.num_cams,
                    c.num_learnable_pts, c.dfa_gather_capacity,
                )
            elif op == "refine3d":
                # intermediate layers report no cls/quality at inference
                with_cls = (num_refine3d == c.num_single_frame_decoder - 1
                            or i == len(order) - 1)
                num_refine3d += 1
                mod = SparseBox3DRefinementModule(
                    e, num_cls=c.num_classes, with_cls=with_cls,
                    with_quality_estimation=c.with_quality_estimation,
                )
            elif op == "refine2d":
                mod = SparseBox2DRefinementModule(e, num_cls=c.num_classes)
            elif op == "qg_self_attn":
                mod = QueryGroupSelfAttention(2 * e, c.num_groups, c.num_cams)
            elif op == "qg_cross_attn":
                mod = QueryGroupMSDA(
                    e, c.num_groups, c.num_levels, 4, c.num_cams,
                    gather_capacity=c.msda_gather_capacity,
                    sel_levels=c.msda_sel_levels or None,
                    patch_hw=c.msda_patch_hw,
                )
            elif op == "aggregation":
                self.add_module(f"op{i}_reweight", ReWeight(e))
                op = "aggregation_attn"
                mod = ResidualAttention(2 * e, c.num_groups)
            elif op == "allocation":
                self.op_names.append(None)
                continue
            else:
                raise NotImplementedError(op)
            name = f"op{i}_{op}"
            self.add_module(name, mod)
            self.op_names.append(name)

    def graph_model(self, layer, query, key=None, value=None,
                    query_pos=None, key_pos=None):
        """Decoupled attention: concat (query, pos) [and (key, pos)],
        value through fc_before, output through fc_after."""
        query = torch.cat([query, query_pos], dim=-1)
        if key is not None:
            key = torch.cat([key, key_pos], dim=-1)
        if value is not None:
            value = self.fc_before(value)
        return self.fc_after(layer(query, key, value))

    def forward(
        self,
        col_feats: torch.Tensor,  # [bs, cams, ΣHW, C]
        spatial_shapes: SpatialShapes,
        projection_mat: torch.Tensor,  # [bs, cams, 4, 4]
        image_wh: tuple,  # static (W, H)
        temporal: Optional[TemporalState] = None,
        time_interval: Optional[torch.Tensor] = None,  # [bs]
        temp2cur: Optional[torch.Tensor] = None,  # [bs, 4, 4]
    ) -> Dict[str, Any]:
        c = self.cfg
        bs = col_feats.shape[0]
        dev = col_feats.device
        image_wh_arr = torch.tensor(
            image_wh, dtype=torch.float32, device=dev
        )[None, None].expand(bs, c.num_cams, 2)

        (instance_feature, anchor, temp_instance_feature, temp_anchor,
         time_interval, temp_mask) = self.bank.get(
            self.anchor, self.instance_feature, bs, temporal, time_interval,
            temp2cur,
        )
        anchor_embed = self.anchor_encoder(anchor)
        temp_anchor_embed = (self.anchor_encoder(temp_anchor)
                             if temp_anchor is not None else None)

        prediction, classification, quality = [], [], []
        prediction2d, classification2d, prediction_alpha2d = [], [], []
        alloc_list: List[Allocation] = []
        temp_attn_instance = instance_feature
        alloc: Optional[Allocation] = None
        anchor2d = anchor_embed2d = feat2d = None
        last = len(c.operation_order) - 1

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
                    anchor, projection_mat, image_wh,
                    capacity=c.allocation_capacity,
                )
                feat2d = dispatch_to_2d(alloc, instance_feature)
                anchor2d = alloc.anchor2d
                anchor_embed2d = self.anchor_encoder2d(anchor2d)
            elif op == "qg_self_attn":
                query = torch.cat([feat2d, anchor_embed2d], dim=-1)
                out = layer(query, self.fc_before2d(feat2d), alloc.valid)
                feat2d = self.fc_after2d(out)
            elif op == "qg_cross_attn":
                feat2d = layer(
                    feat2d, anchor_embed2d, alloc.anchor2d[..., :2],
                    alloc.ref_depth, col_feats, spatial_shapes,
                )
            elif op == "refine2d":
                box2d, cls2d, alpha2d = layer(feat2d, anchor2d,
                                              anchor_embed2d)
                prediction2d.append(box2d)
                classification2d.append(cls2d)
                prediction_alpha2d.append(alpha2d)
                alloc_list.append(alloc)
                anchor2d = box2d
            elif op == "aggregation":
                reweight = getattr(self, f"op{i}_reweight")
                from2d, pos_from2d = reweight(
                    feat2d, anchor_embed2d, alloc.trans_matrix,
                    alloc.center_matrix,
                )
                query3d = temp_attn_instance + from2d
                anchor_embed = anchor_embed + pos_from2d
                instance_feature = self.graph_model(
                    layer, query3d, value=query3d, query_pos=anchor_embed
                )
                feat2d = None
            elif op == "gnn":
                instance_feature = self.graph_model(
                    layer, instance_feature, value=instance_feature,
                    query_pos=anchor_embed,
                )
            elif op == "temp_gnn":
                if temp_instance_feature is None:
                    # cold start: value = key = concat(query, pos), no
                    # fc_before (mmcv MultiheadAttention None-defaulting)
                    instance_feature = self.graph_model(
                        layer, instance_feature, query_pos=anchor_embed
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
                )
            elif op == "refine3d":
                return_cls = (
                    len(prediction) == c.num_single_frame_decoder - 1
                    or i == last
                )
                anchor, cls, qt = layer(instance_feature, anchor,
                                        anchor_embed, time_interval,
                                        return_cls)
                prediction.append(anchor)
                classification.append(cls)
                quality.append(qt)
                if (len(prediction) == c.num_single_frame_decoder
                        and temporal is not None):
                    instance_feature, anchor = self.bank.update(
                        instance_feature, anchor, cls,
                        temp_instance_feature, temp_anchor, temp_mask,
                    )
                if i != last:
                    anchor_embed = self.anchor_encoder(anchor)
                if (len(prediction) > c.num_single_frame_decoder
                        and temp_anchor_embed is not None):
                    temp_anchor_embed = anchor_embed[:, : c.num_temp_instances]
            else:
                raise NotImplementedError(op)

        output: Dict[str, Any] = dict(
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
        instance_id, new_state = self.bank.assign_instance_ids(
            cls_final, new_state, temp_confidence,
            threshold=c.score_threshold, temp_mask=temp_mask,
        )
        output["instance_id"] = instance_id
        output["temporal_state"] = new_state
        return output
