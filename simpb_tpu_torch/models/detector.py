"""SimPB detector: trunk -> FPN -> packed features -> decoder head
(port of the inference path of `simpb_tpu/models/detector.py`).

The six cameras fold into the batch for the trunk, which always runs
the fused inference path (`models/backbone.py`): in the JAX package
`backbone_fused_infer` picks between two trunks that compute the same
function; the port has only this one until the training path brings
the module trunk. The trunk computes in `compute_dtype` and the feature
column stays in it; the head computes in `head_dtype` (`bench.py`
serves both in bfloat16). Not ported yet: `stem_s2d` and FPNs with
other than 4 levels.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..configs.base import ModelConfig
from ..ops.format import pack_feature_maps
from .backbone import FPN, ResNet
from .head import SimPBHead, check_head_config
from .instance_bank import TemporalState

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_serving_config(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a setting the port does not serve
    yet; `SimPB` calls it before it builds anything."""
    if cfg.stem_s2d:
        raise NotImplementedError("stem_s2d is not ported yet")
    if cfg.head.num_levels != 4:
        raise NotImplementedError("FPNs with other than 4 levels are not "
                                  "ported yet")
    check_head_config(cfg.head)


class SimPB(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_serving_config(cfg)
        self.cfg = cfg
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.img_backbone = ResNet(cfg.backbone_depth)
        self.img_neck = FPN((256, 512, 1024, 2048), cfg.head.embed_dims)
        self.head = SimPBHead(cfg.head, DTYPES[cfg.head_dtype])

    def extract_feat(self, img: torch.Tensor):
        """img [bs, cams, H, W, 3] -> (col_feats [bs, cams, ΣHW, C],
        spatial_shapes)."""
        bs, cams = img.shape[:2]
        x = img.reshape((bs * cams,) + tuple(img.shape[2:]))
        feats = self.img_backbone(x, self.compute_dtype)
        feats = self.img_neck(feats, self.compute_dtype)
        feats = [f.reshape((bs, cams) + tuple(f.shape[1:])) for f in feats]
        return pack_feature_maps(feats)

    @torch.no_grad()
    def forward(
        self,
        img: torch.Tensor,  # [bs, cams, H, W, 3]
        projection_mat: torch.Tensor,  # [bs, cams, 4, 4]
        temporal: Optional[TemporalState] = None,
        time_interval: Optional[torch.Tensor] = None,  # [bs]
        temp2cur: Optional[torch.Tensor] = None,  # [bs, 4, 4]
    ) -> Dict[str, Any]:
        col_feats, spatial_shapes = self.extract_feat(img)
        return self.head(
            col_feats, spatial_shapes, projection_mat.float(),
            self.cfg.input_size, temporal=temporal,
            time_interval=time_interval, temp2cur=temp2cur,
        )
