"""Packed multi-camera multi-scale feature layout.

Port of `simpb_tpu/ops/format.py`: per-level `[bs, cams, H, W, C]` maps
pack into one channels-last column `[bs, cams, ΣHW, C]`, with the
per-level spatial shapes carried as static Python metadata.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch


@dataclass(frozen=True)
class SpatialShapes:
    """Static per-level (H, W) metadata for a packed feature column."""

    shapes: Tuple[Tuple[int, int], ...]

    @property
    def num_levels(self) -> int:
        return len(self.shapes)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(h * w for h, w in self.shapes)

    @property
    def start_indices(self) -> Tuple[int, ...]:
        starts, acc = [], 0
        for s in self.sizes:
            starts.append(acc)
            acc += s
        return tuple(starts)

    @property
    def total(self) -> int:
        return sum(self.sizes)


def pack_feature_maps(
    feature_maps: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, SpatialShapes]:
    """Pack per-level `[bs, cams, H, W, C]` maps into `[bs, cams, ΣHW, C]`."""
    shapes = tuple((int(f.shape[2]), int(f.shape[3])) for f in feature_maps)
    bs, cams = feature_maps[0].shape[:2]
    cols = [f.reshape(bs, cams, -1, f.shape[-1]) for f in feature_maps]
    return torch.cat(cols, dim=2), SpatialShapes(shapes)


def unpack_feature_maps(
    col_feats: torch.Tensor, spatial_shapes: SpatialShapes
) -> List[torch.Tensor]:
    """Inverse of :func:`pack_feature_maps`."""
    bs, cams, _, c = col_feats.shape
    return [
        col_feats[:, :, start : start + size].reshape(bs, cams, h, w, c)
        for (h, w), start, size in zip(
            spatial_shapes.shapes, spatial_shapes.start_indices,
            spatial_shapes.sizes,
        )
    ]
