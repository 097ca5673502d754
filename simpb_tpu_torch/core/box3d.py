"""3D box state-vector codec and geometry.

Port of `simpb_tpu/core/box3d.py`. The anchor / box state layout:

    undecoded state vector (11 dims):
        [X, Y, Z, W, L, H, SIN_YAW, COS_YAW, VX, VY, VZ]
    where W/L/H are *log* sizes and yaw is stored as (sin, cos).

    decoded box (nuScenes LiDAR convention, 10 dims):
        [x, y, z, w, l, h, yaw, vx, vy, vz]

Geometry is computed in float32 with full-precision products (the
callers keep TF32 off for matmuls, PyTorch's default).
"""
from __future__ import annotations

from typing import Optional

import torch

X, Y, Z, W, L, H, SIN_YAW, COS_YAW, VX, VY, VZ = range(11)
CNS, YNS = 0, 1
YAW = 6

STATE_DIM = 11

_XYZ = [X, Y, Z]
_WLH = [W, L, H]


def decode_box(box: torch.Tensor) -> torch.Tensor:
    """Undecoded 11-dim state -> decoded 10-dim box."""
    yaw = torch.atan2(box[..., SIN_YAW], box[..., COS_YAW])
    return torch.cat(
        [box[..., _XYZ], torch.exp(box[..., _WLH]), yaw[..., None],
         box[..., VX:]],
        dim=-1,
    )


def encode_box(box: torch.Tensor, vel_dims: int = 3) -> torch.Tensor:
    """Decoded GT box -> 11-dim anchor parameterisation."""
    return torch.cat(
        [
            box[..., _XYZ],
            torch.log(torch.clamp(box[..., _WLH], min=1e-8)),
            torch.sin(box[..., YAW])[..., None],
            torch.cos(box[..., YAW])[..., None],
            box[..., YAW + 1 : YAW + 1 + vel_dims],
        ],
        dim=-1,
    )


def yaw_rotation_matrix(anchor: torch.Tensor) -> torch.Tensor:
    """[..., 11] anchors -> [..., 3, 3] rotation about z by the yaw."""
    cos = anchor[..., COS_YAW]
    sin = anchor[..., SIN_YAW]
    zero = torch.zeros_like(cos)
    one = torch.ones_like(cos)
    return torch.stack(
        [
            torch.stack([cos, -sin, zero], dim=-1),
            torch.stack([sin, cos, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def box_corners(
    anchor: torch.Tensor, size_clip: Optional[tuple] = None
) -> torch.Tensor:
    """[..., 11] anchors -> [..., 8, 3] world-frame corners, in the
    `unravel_index(arange(8), [2, 2, 2]) - 0.5` order."""
    idx = torch.arange(8, device=anchor.device)
    corners_norm = (
        torch.stack([(idx // 4) % 2, (idx // 2) % 2, idx % 2], dim=-1).to(
            anchor.dtype
        )
        - 0.5
    )
    size = torch.exp(anchor[..., _WLH])
    if size_clip is not None:
        size = torch.minimum(
            size, torch.tensor(size_clip, dtype=anchor.dtype,
                               device=anchor.device)
        )
    corners = size[..., None, :] * corners_norm
    rot = yaw_rotation_matrix(anchor)
    corners = torch.einsum("...ij,...kj->...ki", rot, corners)
    return corners + anchor[..., None, _XYZ]


def project_points(
    key_points: torch.Tensor,  # [bs, A, P, 3]
    projection_mat: torch.Tensor,  # [bs, cams, 4, 4]
    image_wh: Optional[torch.Tensor] = None,  # [bs, cams, 2]
    min_depth: float = 1e-5,
) -> torch.Tensor:
    """Project key points into every camera -> [bs, cams, A, P, 2]."""
    pts = torch.cat([key_points, torch.ones_like(key_points[..., :1])], -1)
    proj = torch.einsum("bnij,bapj->bnapi", projection_mat, pts)
    pts2d = proj[..., :2] / torch.clamp(proj[..., 2:3], min=min_depth)
    if image_wh is not None:
        pts2d = pts2d / image_wh[:, :, None, None]
    return pts2d


def anchor_projection(
    anchor: torch.Tensor,  # [bs, N, 11]
    T_src2dst: torch.Tensor,  # [bs, 4, 4]
    time_interval: Optional[torch.Tensor] = None,  # [bs]
) -> torch.Tensor:
    """Ego-motion-compensate anchors across frames.

    Keeps the reference's yaw-layout quirk bit for bit: the rotated yaw
    vector is computed from [COS_YAW, SIN_YAW] and written back into the
    [SIN_YAW, COS_YAW] slots unswapped (checkpoint parity).
    """
    vel = anchor[..., VX:]
    vel_dim = vel.shape[-1]
    T = T_src2dst[:, None].to(anchor.dtype)  # [bs, 1, 4, 4]
    center = anchor[..., _XYZ]
    if time_interval is not None:
        center = center - vel * time_interval[:, None, None].to(vel.dtype)
    center = (T[..., :3, :3] @ center[..., None]).squeeze(-1) + T[..., :3, 3]
    size = anchor[..., _WLH]
    yaw = (T[..., :2, :2] @ anchor[..., [COS_YAW, SIN_YAW]][..., None])
    vel = (T[..., :vel_dim, :vel_dim] @ vel[..., None]).squeeze(-1)
    return torch.cat([center, size, yaw.squeeze(-1), vel], dim=-1)
