"""SimPB detector: trunk -> FPN -> packed features -> decoder head
(port of `simpb_tpu/models/detector.py`).

The six cameras fold into the batch for the trunk. Serving
(`train=False`, under `torch.no_grad`) picks the trunk by JAX's rule
(`simpb_tpu/models/detector.py:69-74`): the fused inference trunk of
`models/backbone.py` (K1-K4) when `backbone_fused_infer` is set and
`stem_s2d` is not, else the module trunk at inference (BatchNorm on the
running statistics, the space-to-depth stem under `stem_s2d`) and the
module FPN; both in `compute_dtype`. Training (`train=True`) runs the
JAX training path: the grid mask on the folded images, the module trunk
(rematerialised per bottleneck under `backbone_remat`) and module FPN,
`depth_preds` from the `DenseDepthNet`, and the head's training
program. The feature column
stays in the trunk's dtype; the head computes in `head_dtype`. `rngs`
holds the training generators under JAX's rng names: "aug" (grid mask),
"dropout" and "sampling". Not ported yet: FPNs with other than 4 levels.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..configs.base import ModelConfig
from ..ops.format import pack_feature_maps
from ..training.dn import DnState
from ..training.targets3d import DnBundle
from .backbone import FPN, DenseDepthNet, ResNet
from .grid_mask import grid_mask
from .head import SimPBHead, check_head_config
from .instance_bank import TemporalState
from .layers import dropout_generator

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_serving_config(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a setting the port does not serve or
    train yet; `SimPB` calls it before it builds anything. The port
    trains every configuration it serves, windowed or exact MSDA."""
    if cfg.head.num_levels != 4:
        raise NotImplementedError("FPNs with other than 4 levels are not "
                                  "ported yet")
    check_head_config(cfg.head)


def uses_fused_trunk(cfg: ModelConfig) -> bool:
    """JAX's serving rule: the fused trunk iff `backbone_fused_infer` and
    not `stem_s2d`; else the module trunk."""
    return cfg.backbone_fused_infer and not cfg.stem_s2d


class SimPB(nn.Module):
    """`train=True` builds the training tree: the depth branch and every
    refine3d's class and quality branches."""

    def __init__(self, cfg: ModelConfig, train: bool = False):
        super().__init__()
        check_serving_config(cfg)
        self.cfg = cfg
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.fused_trunk = uses_fused_trunk(cfg)
        self.img_backbone = ResNet(cfg.backbone_depth, cfg.stem_s2d)
        self.img_neck = FPN((256, 512, 1024, 2048), cfg.head.embed_dims)
        self.head = SimPBHead(cfg.head, DTYPES[cfg.head_dtype], train)
        if train:
            self.depth_branch = DenseDepthNet(cfg.num_depth_layers,
                                              cfg.head.embed_dims)

    def extract_feat(self, img: torch.Tensor):
        """img [bs, cams, H, W, 3] -> (col_feats [bs, cams, ΣHW, C],
        spatial_shapes)."""
        bs, cams = img.shape[:2]
        x = img.reshape((bs * cams,) + tuple(img.shape[2:]))
        dtype = self.compute_dtype
        if self.fused_trunk:
            feats = self.img_neck(self.img_backbone(x, dtype), dtype)
        else:
            feats = self.img_neck.forward_train(
                self.img_backbone.forward_module(x, dtype), dtype)
        feats = [f.reshape((bs, cams) + tuple(f.shape[1:])) for f in feats]
        return pack_feature_maps(feats)

    def extract_feat_train(self, img: torch.Tensor, focal=None,
                           aug: Optional[torch.Generator] = None):
        """The training trunk: img [bs, cams, H, W, 3] -> (col_feats,
        spatial_shapes, depth_preds)."""
        bs, cams = img.shape[:2]
        x = img.reshape((bs * cams,) + tuple(img.shape[2:]))
        if self.cfg.use_grid_mask:
            if aug is None:
                raise ValueError("training with the grid mask needs an "
                                 "'aug' generator")
            x = grid_mask(aug, x)
        feats = self.img_backbone.forward_train(x, self.compute_dtype,
                                                self.cfg.backbone_remat)
        feats = self.img_neck.forward_train(feats, self.compute_dtype)
        feats = [f.reshape((bs, cams) + tuple(f.shape[1:])) for f in feats]
        depths = self.depth_branch(feats, focal)
        col_feats, spatial_shapes = pack_feature_maps(feats)
        return col_feats, spatial_shapes, depths

    def forward(
        self,
        img: torch.Tensor,  # [bs, cams, H, W, 3]
        projection_mat: torch.Tensor,  # [bs, cams, 4, 4]
        temporal: Optional[TemporalState] = None,
        time_interval: Optional[torch.Tensor] = None,  # [bs]
        temp2cur: Optional[torch.Tensor] = None,  # [bs, 4, 4]
        focal: Optional[torch.Tensor] = None,  # [bs, cams]
        dn: Optional[DnBundle] = None,
        dn_state: Optional[DnState] = None,
        train: bool = False,
        rngs: Optional[Dict[str, torch.Generator]] = None,
    ) -> Dict[str, Any]:
        if not train:
            with torch.no_grad():
                col_feats, spatial_shapes = self.extract_feat(img)
                return self.head(
                    col_feats, spatial_shapes, projection_mat.float(),
                    self.cfg.input_size, temporal=temporal,
                    time_interval=time_interval, temp2cur=temp2cur,
                )
        rngs = rngs or {}
        col_feats, spatial_shapes, depths = self.extract_feat_train(
            img, focal, rngs.get("aug"))
        with dropout_generator(rngs.get("dropout")):
            outs = self.head(
                col_feats, spatial_shapes, projection_mat.float(),
                self.cfg.input_size, temporal=temporal,
                time_interval=time_interval, temp2cur=temp2cur, dn=dn,
                dn_state=dn_state, train=True,
                sampling=rngs.get("sampling"),
            )
        outs["depth_preds"] = depths
        return outs
