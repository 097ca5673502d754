"""Synthetic-but-realistic geometry and seeded random weights.

The rig and anchors are the port's own copy of
`simpb_tpu/utils/synthetic.py`: a 6-camera surround rig with
nuScenes-like geometry (704x256 preprocessing of 1600x900 images,
yaw-distributed extrinsics) so each anchor projects into ~1-2 cameras,
and k-means-like 3D anchors over the 55 m BEV disc. `randomize_` fills a
model with seeded random weights made with numpy.
"""
from __future__ import annotations

import numpy as np

# (yaw deg, right-offset m, forward-offset m) per camera, nuScenes layout
_CAM_LAYOUT = (
    (0.0, 0.0, 1.7),  # FRONT
    (55.0, -0.5, 1.5),  # FRONT_LEFT
    (-55.0, 0.5, 1.5),  # FRONT_RIGHT
    (110.0, -0.5, 1.0),  # BACK_LEFT
    (-110.0, 0.5, 1.0),  # BACK_RIGHT
    (180.0, 0.0, 0.0),  # BACK (wider FOV on the real rig)
)


def synthetic_rig(
    bs: int,
    image_wh: tuple[int, int] = (704, 256),
    num_cams: int = 6,
    jitter: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """[bs, num_cams, 4, 4] lidar->image projection matrices.

    Geometry convention matches the dataset layer (`data/dataset.py`):
    points live in the lidar frame (x right, y forward, z up); the
    projection matrix is K4 @ lidar2cam with camera axes (x right,
    y down, z forward).
    """
    img_w, img_h = image_wh
    # released preprocessing: 1600x900 -> resize 0.44 -> crop 140 px top
    scale = img_w / 1600.0
    fx = 1266.0 * scale
    cx = 800.0 * scale
    cy = 450.0 * scale - (900.0 * scale - img_h)

    rng = np.random.default_rng(seed)
    mats = np.zeros((bs, num_cams, 4, 4), np.float32)
    for b in range(bs):
        for n in range(num_cams):
            yaw_deg, right_off, fwd_off = _CAM_LAYOUT[n % len(_CAM_LAYOUT)]
            yaw = np.deg2rad(yaw_deg)
            if jitter > 0:
                yaw += rng.normal() * jitter
            # camera basis in the lidar frame (x right, y forward, z up):
            # forward along yaw (0 = +y forward), right 90 deg clockwise
            f = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
            r = np.array([np.cos(yaw), np.sin(yaw), 0.0])
            d = np.array([0.0, 0.0, -1.0])
            rot = np.stack([r, d, f])  # lidar -> camera rotation
            c = r * right_off + f * fwd_off + np.array([0.0, 0.0, 1.5])
            t = -rot @ c
            l2c = np.eye(4)
            l2c[:3, :3] = rot
            l2c[:3, 3] = t
            k4 = np.eye(4)
            k4[0, 0] = fx
            k4[1, 1] = fx
            k4[0, 2] = cx
            k4[1, 2] = cy
            mats[b, n] = (k4 @ l2c).astype(np.float32)
    return mats


def synthetic_anchors(num_anchor: int, seed: int = 0) -> np.ndarray:
    """[num_anchor, 11] k-means-like anchor states.

    Matches the distribution of `tools/anchor_generator.py` output on
    real data: centers uniform over the 55 m BEV disc, z near ground,
    log-dims around car scale, unit-ish yaw encoding, zero velocity.
    State layout [x, y, z, logw, logl, logh, sin_yaw, cos_yaw, vx, vy, vz]
    (core/box3d.py constants).
    """
    rng = np.random.default_rng(seed)
    r = 55.0 * np.sqrt(rng.uniform(0.04, 1.0, num_anchor))
    theta = rng.uniform(-np.pi, np.pi, num_anchor)
    x = r * np.cos(theta)
    y = r * np.sin(theta)
    z = rng.normal(-1.0, 0.3, num_anchor)
    logw = np.log(1.9) + rng.normal(0, 0.2, num_anchor)
    logl = np.log(4.6) + rng.normal(0, 0.2, num_anchor)
    logh = np.log(1.7) + rng.normal(0, 0.2, num_anchor)
    yaw = rng.uniform(-np.pi, np.pi, num_anchor)
    out = np.stack(
        [
            x, y, z, logw, logl, logh,
            np.sin(yaw), np.cos(yaw),
            np.zeros(num_anchor), np.zeros(num_anchor), np.zeros(num_anchor),
        ],
        axis=-1,
    ).astype(np.float32)
    return out


def randomize_(model, seed: int = 0):
    """Fill every parameter and BatchNorm buffer of `model` in place
    with seeded random values at scales that keep activations in range
    (fan-in-scaled products, near-unit norms and scales), and install
    the synthetic anchors. Returns the model."""
    import torch
    import torch.nn as nn

    rng = np.random.default_rng(seed)

    def put(t, arr):
        t.copy_(torch.from_numpy(np.asarray(arr, np.float32)).reshape(
            t.shape))

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                # refinement deltas (out_fc) stay small, as in a trained
                # model; full-size random deltas make the decoder chaotic
                gain = 0.1 if name.endswith("out_fc") else 1.0
                put(mod.weight, gain * rng.normal(size=mod.weight.shape)
                    / np.sqrt(fan_in))
                if mod.bias is not None:
                    put(mod.bias, rng.normal(size=mod.bias.shape) * 0.02)
            elif isinstance(mod, nn.LayerNorm):
                put(mod.weight, 1.0 + 0.1 * rng.normal(size=mod.weight.shape))
                put(mod.bias, 0.02 * rng.normal(size=mod.bias.shape))
            elif isinstance(mod, nn.BatchNorm2d):
                n = mod.num_features
                put(mod.weight, rng.uniform(0.8, 1.2, n))
                put(mod.bias, rng.normal(size=n) * 0.1)
                put(mod.running_mean, rng.normal(size=n) * 0.1)
                put(mod.running_var, rng.uniform(0.5, 1.5, n))
            elif type(mod).__name__ == "Scale":
                put(mod.scale, 1.0 + 0.1 * rng.normal(size=mod.scale.shape))
        for name, p in model.named_parameters():
            if name.endswith("anchor") and p.dim() == 2 and p.shape[1] == 11:
                put(p, synthetic_anchors(p.shape[0], seed))
    return model
