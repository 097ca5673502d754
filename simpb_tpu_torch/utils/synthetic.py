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


# typical (w, l, h) in metres of each class of `write_synthetic_infos`
_CLASS_DIMS = {
    "car": (1.9, 4.6, 1.7), "truck": (2.5, 6.9, 2.8), "bus": (2.9, 11.0, 3.5),
    "pedestrian": (0.7, 0.7, 1.8), "bicycle": (0.6, 1.7, 1.3),
    "motorcycle": (0.8, 2.1, 1.5), "trailer": (2.9, 12.0, 3.9),
    "barrier": (2.5, 0.5, 1.0), "traffic_cone": (0.4, 0.4, 1.1),
    "construction_vehicle": (2.8, 6.4, 3.2),
}


def write_synthetic_infos(
    directory: str,
    n_frames: int = 12,
    gap_at=(6,),
    src_hw: tuple[int, int] = (900, 1600),
    num_objects: int = 12,
    seed: int = 0,
    write_images: bool = False,
    with_2d: bool = False,
    with_lidar: bool = False,
) -> str:
    """Write a nuScenes-format infos pkl (the layout the offline converter
    writes and `data/dataset.py` reads) and return its path.

    Six cameras in the rig of `synthetic_rig` (yaw-distributed, 1266 px
    focal length at 1600 px width, scaled to `src_hw`), so the objects
    around the car are in view. Frames are 0.5 s apart; a gap of 10 s
    before each frame index in `gap_at` starts a new scene (the
    `sequence_eval_shards` rule), with new objects. Each scene's objects
    (cycling through the classes, 5-40 m from the car, persistent
    instance ids) move at constant velocity in the global frame while
    the car drives forward and turns slowly; their boxes are stored in
    the lidar frame. With `write_images`, each camera image is a seeded
    random PNG under `directory/imgs` (needs Pillow); otherwise the
    paths are named but not written.

    What training reads, both off by default (so the defaults write the
    same pkl as before):
    - `with_2d`: per camera `bboxes2d` [n, 4], `labels2d`, `centers2d`
      [n, 2], `depths` and `gt_2d_3d_map` (the layout of the offline
      converter): the projected 3D box of each object whose centre the
      camera sees, plus one 2D box without a 3D parent (map -1) in the
      first camera;
    - `with_lidar`: a `lidar_path` per frame, a float32 [N, 5] `.bin`
      (x, y, z, intensity, ring; `np.tofile`) of points on the ground
      and inside the objects, drawn from a generator of its own so the
      images and boxes stay those of the defaults."""
    import os
    import pickle

    from ..configs.base import CLASS_NAMES

    src_h, src_w = src_hw
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(directory, "imgs")
    if write_images:
        from PIL import Image

        os.makedirs(img_dir, exist_ok=True)
    scale = src_w / 1600.0
    k = np.array([[1266.0 * scale, 0, src_w / 2], [0, 1266.0 * scale,
                                                   src_h / 2], [0, 0, 1]])
    cams = []
    for yaw_deg, right_off, fwd_off in _CAM_LAYOUT:
        yaw = np.deg2rad(yaw_deg)
        f = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
        r = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        rot = np.stack([r, np.array([0.0, 0.0, -1.0]), f])  # lidar -> cam
        center = r * right_off + f * fwd_off + np.array([0.0, 0.0, 1.5])
        cams.append((rot.T, center))

    infos, scene = [], -1
    lidar_rng = np.random.default_rng(seed + 7919)
    if with_lidar:
        os.makedirs(os.path.join(directory, "lidar"), exist_ok=True)
    for i in range(n_frames):
        if i == 0 or i in gap_at:
            scene += 1
            names = [CLASS_NAMES[j % len(CLASS_NAMES)]
                     for j in range(num_objects)]
            dist = rng.uniform(5.0, 40.0, num_objects)
            theta = rng.uniform(-np.pi, np.pi, num_objects)
            pos0 = np.stack([dist * np.cos(theta), dist * np.sin(theta),
                             np.full(num_objects, -1.0)], -1)
            vel = rng.uniform(-2.0, 2.0, (num_objects, 2))
            yaw0 = rng.uniform(-np.pi, np.pi, num_objects)
            dims = np.array([_CLASS_DIMS[n] for n in names])
            t0, ego0 = i, np.array([40.0 * scene, 0.0, 0.0])
        t = 0.5 * (i - t0)
        ego_yaw = 0.02 * (i - t0)
        ego_t = ego0 + np.array([0.0, 4.0 * t, 0.0])
        c, s = np.cos(ego_yaw), np.sin(ego_yaw)
        ego_r = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        pos = ego0 + pos0 + np.concatenate([vel * t, np.zeros((num_objects,
                                                               1))], -1)
        boxes = np.zeros((num_objects, 7))
        boxes[:, :3] = (pos - ego_t) @ ego_r  # global -> lidar (= ego)
        boxes[:, 3:6] = dims
        boxes[:, 6] = yaw0 - ego_yaw
        cam_infos, ann2d = {}, []
        for cam_no, (s2l_rot, center) in enumerate(cams):
            if with_2d:
                ann2d.append(_project_boxes(boxes, names, s2l_rot.T, center,
                                            k, src_hw, orphan=cam_no == 0))
            path = os.path.join(img_dir, f"img_{i}_{cam_no}.png")
            if write_images:
                # stored, not deflated: random pixels do not compress,
                # and deflating 1600x900 ones takes a third of a second
                Image.fromarray(rng.integers(0, 256, (src_h, src_w, 3),
                                             dtype=np.uint8)).save(
                    path, compress_level=0)
            cam_infos[f"CAM{cam_no}"] = dict(
                data_path=path, sensor2lidar_rotation=s2l_rot,
                sensor2lidar_translation=center, cam_intrinsic=k)
        lidar_path = None
        if with_lidar:
            lidar_path = os.path.join(directory, "lidar", f"pts_{i}.bin")
            _lidar_points(lidar_rng, boxes).tofile(lidar_path)
        extra = {}
        if with_2d:
            extra = {key: [a[key] for a in ann2d] for key in (
                "bboxes2d", "labels2d", "centers2d", "depths",
                "gt_2d_3d_map")}
        infos.append(dict(
            token=f"tok{i}",
            cams=cam_infos,
            timestamp=(1.5e9 + 0.5 * i + 10.0 * scene) * 1e6,
            lidar_path=lidar_path,
            sweeps=[] if i == t0 else [1],
            lidar2ego_rotation=[1.0, 0.0, 0.0, 0.0],
            lidar2ego_translation=[0.0, 0.0, 0.0],
            ego2global_rotation=[np.cos(ego_yaw / 2), 0.0, 0.0,
                                 np.sin(ego_yaw / 2)],
            ego2global_translation=ego_t.tolist(),
            gt_boxes=boxes,
            gt_names=np.array(names),
            gt_velocity=vel @ ego_r[:2, :2],
            num_lidar_pts=np.full(num_objects, 5),
            valid_flag=np.ones(num_objects, bool),
            instance_inds=np.arange(num_objects) + 1000 * scene,
            **extra,
        ))
    path = os.path.join(directory, "infos.pkl")
    with open(path, "wb") as f:
        pickle.dump({"infos": infos, "metadata": {"version": "synthetic"}}, f)
    return path


def _box_corners(boxes: np.ndarray) -> np.ndarray:
    """[n, 7] (x, y, z, w, l, h, yaw) -> [n, 9, 3]: the 8 corners, then
    the centre."""
    signs = np.array([[sx, sy, sz] for sx in (-.5, .5) for sy in (-.5, .5)
                      for sz in (-.5, .5)])
    x, y, z, w, l, h, yaw = boxes[:, :7].T
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    local = signs[None] * np.stack([w, l, h], -1)[:, None]
    corners = np.stack([x[:, None] + local[..., 0] * c - local[..., 1] * s,
                        y[:, None] + local[..., 0] * s + local[..., 1] * c,
                        z[:, None] + local[..., 2]], -1)
    return np.concatenate([corners, boxes[:, None, :3]], 1)


def _project_boxes(boxes, names, l2c_rot, center, k, src_hw, orphan):
    """One camera's 2D GT at the source resolution: each object whose
    centre projects into the image, its box the projected corners in
    front of the camera (clipped to the image), its centre and depth,
    its 3D index; with `orphan`, one more box mapped to no 3D box."""
    from ..configs.base import CLASS_NAMES

    src_h, src_w = src_hw
    pts = (_box_corners(boxes) - center) @ l2c_rot.T  # [n, 9, 3] camera
    depth = pts[..., 2]
    uv = pts[..., :2] @ k[:2, :2].T / np.maximum(depth[..., None], 1e-5) \
        + k[:2, 2]
    b2d, lab, c2d, dep, m2d = [], [], [], [], []
    for j in range(len(boxes)):
        cu, cv = uv[j, 8]
        if depth[j, 8] <= 0.1 or not (0 < cu < src_w and 0 < cv < src_h):
            continue
        front = uv[j, :8][depth[j, :8] > 0.1]
        b2d.append([np.clip(front[:, 0].min(), 0, src_w),
                    np.clip(front[:, 1].min(), 0, src_h),
                    np.clip(front[:, 0].max(), 0, src_w),
                    np.clip(front[:, 1].max(), 0, src_h)])
        lab.append(CLASS_NAMES.index(names[j]))
        c2d.append([cu, cv])
        dep.append(depth[j, 8])
        m2d.append(j)
    if orphan:
        b2d.append([0.1 * src_w, 0.1 * src_h, 0.3 * src_w, 0.3 * src_h])
        lab.append(0)
        c2d.append([0.2 * src_w, 0.2 * src_h])
        dep.append(15.0)
        m2d.append(-1)
    return {"bboxes2d": np.asarray(b2d, np.float32).reshape(-1, 4),
            "labels2d": np.asarray(lab, np.int64),
            "centers2d": np.asarray(c2d, np.float32).reshape(-1, 2),
            "depths": np.asarray(dep, np.float32),
            "gt_2d_3d_map": np.asarray(m2d, np.int64)}


def _lidar_points(rng, boxes, ground: int = 4000, per_object: int = 64):
    """[N, 5] float32 lidar points: the ground around the car (1.8 m
    below the sensor) and points inside each box."""
    g = np.stack([rng.uniform(-50, 50, ground), rng.uniform(-50, 50, ground),
                  np.full(ground, -1.8)], -1)
    local = rng.uniform(-0.5, 0.5, (len(boxes), per_object, 3)) * \
        boxes[:, None, 3:6]
    c, s = np.cos(boxes[:, 6])[:, None], np.sin(boxes[:, 6])[:, None]
    obj = np.stack([boxes[:, None, 0] + local[..., 0] * c - local[..., 1] * s,
                    boxes[:, None, 1] + local[..., 0] * s + local[..., 1] * c,
                    boxes[:, None, 2] + local[..., 2]], -1).reshape(-1, 3)
    xyz = np.concatenate([g, obj])
    extra = np.stack([rng.uniform(0, 255, len(xyz)), np.zeros(len(xyz))], -1)
    return np.concatenate([xyz, extra], -1).astype(np.float32)


def synthetic_train_batch(cfg, bs: int, seed: int = 0, num_objects: int = 24,
                          max_gt3d: int = 128, max_gt2d: int = 64):
    """A training batch in the train step's contract, numpy arrays at
    the config's shapes on the synthetic rig: `num_objects` boxes a
    sample on the ground around the ego car (in view of the cameras),
    GT padded to `max_gt3d` 3D and `max_gt2d` 2D boxes a camera (the data
    pipeline's `pad_sample` sizes), each object's 2D box in every camera
    that sees its centre, and sparse depth maps (the object centres'
    depths) for the first `num_depth_layers` levels."""
    rng = np.random.default_rng(seed)
    w_img, h_img = cfg.input_size
    cams = cfg.head.num_cams
    proj = synthetic_rig(bs, (w_img, h_img), cams)
    n = min(num_objects, max_gt3d)
    boxes = np.zeros((bs, max_gt3d, 9), np.float32)
    r = rng.uniform(6.0, 40.0, (bs, n))
    th = rng.uniform(-np.pi, np.pi, (bs, n))
    boxes[:, :n, 0] = r * np.cos(th)
    boxes[:, :n, 1] = r * np.sin(th)
    boxes[:, :n, 2] = rng.uniform(-1.0, 0.5, (bs, n))
    boxes[:, :n, 3:6] = rng.uniform(0.5, 4.0, (bs, n, 3))
    boxes[:, :n, 6] = rng.uniform(-np.pi, np.pi, (bs, n))
    boxes[:, :n, 7:9] = rng.normal(size=(bs, n, 2))
    valid = np.zeros((bs, max_gt3d), bool)
    valid[:, :n] = True
    labels = np.zeros((bs, max_gt3d), np.int32)
    labels[:, :n] = rng.integers(0, cfg.head.num_classes, (bs, n))
    inst = np.full((bs, max_gt3d), -1, np.int32)
    inst[:, :n] = np.arange(bs * n).reshape(bs, n)

    vis = np.zeros((bs, max_gt3d, cams), bool)
    b2d_per3d = np.zeros((bs, max_gt3d, cams, 4), np.float32)
    l2d_per3d = np.full((bs, max_gt3d, cams), -1, np.int32)
    a2d_per3d = np.zeros((bs, max_gt3d, cams), np.float32)
    b2d = np.zeros((bs, cams, max_gt2d, 4), np.float32)
    l2d = np.zeros((bs, cams, max_gt2d), np.int32)
    a2d = np.zeros((bs, cams, max_gt2d), np.float32)
    v2d = np.zeros((bs, cams, max_gt2d), bool)
    strides = cfg.strides[: cfg.num_depth_layers]
    depth = [np.zeros((bs, cams, h_img // s, w_img // s), np.float32)
             for s in strides]
    signs = np.array([[sx, sy, sz] for sx in (-.5, .5) for sy in (-.5, .5)
                      for sz in (-.5, .5)], np.float32)
    for b in range(bs):
        for i in range(n):
            x, y, z, bw, bl, bh, yaw = boxes[b, i, :7]
            c, s = np.cos(yaw), np.sin(yaw)
            local = signs * np.array([bw, bl, bh], np.float32)
            corners = np.stack([
                x + local[:, 0] * c - local[:, 1] * s,
                y + local[:, 0] * s + local[:, 1] * c,
                z + local[:, 2]], -1)
            pts = np.concatenate([corners, [[x, y, z]]], 0)
            hom = np.concatenate([pts, np.ones((9, 1), np.float32)], -1)
            for cam in range(cams):
                p = hom @ proj[b, cam].T
                d = p[:, 2]
                if d[8] <= 0.1:
                    continue
                uv = p[:, :2] / np.maximum(d[:, None], 1e-5)
                cu, cv = uv[8]
                if not (0 < cu < w_img and 0 < cv < h_img):
                    continue
                front = d[:8] > 0.1
                box = np.array([
                    np.clip(uv[:8][front, 0].min(), 0, w_img),
                    np.clip(uv[:8][front, 1].min(), 0, h_img),
                    np.clip(uv[:8][front, 0].max(), 0, w_img),
                    np.clip(uv[:8][front, 1].max(), 0, h_img)], np.float32)
                alpha = float(np.arctan2(s, c) - np.arctan2(x, y))
                vis[b, i, cam] = True
                b2d_per3d[b, i, cam] = box
                l2d_per3d[b, i, cam] = labels[b, i]
                a2d_per3d[b, i, cam] = alpha
                k = int(v2d[b, cam].sum())
                if k < max_gt2d:
                    b2d[b, cam, k] = box
                    l2d[b, cam, k] = labels[b, i]
                    a2d[b, cam, k] = alpha
                    v2d[b, cam, k] = True
                for lvl, st in enumerate(strides):
                    depth[lvl][b, cam, int(cv) // st, int(cu) // st] = d[8]
    fx = 1266.0 * w_img / 1600.0
    return {
        "img": rng.normal(size=(bs, cams, h_img, w_img, 3)).astype(
            np.float32),
        "projection_mat": proj,
        "time_interval": np.full((bs,), 0.5, np.float32),
        "temp2cur": np.tile(np.eye(4, dtype=np.float32), (bs, 1, 1)),
        "focal": np.full((bs, cams), fx, np.float32),
        "gt_boxes3d": boxes,
        "gt_labels3d": labels,
        "gt_valid3d": valid,
        "gt_instance_id": inst,
        "gt_boxes2d": b2d,
        "gt_labels2d": l2d,
        "gt_alphas2d": a2d,
        "gt_valid2d": v2d,
        "gt_vis2d_per3d": vis,
        "gt_boxes2d_per3d": b2d_per3d,
        "gt_labels2d_per3d": l2d_per3d,
        "gt_alphas2d_per3d": a2d_per3d,
        "gt_depth": depth,
    }


def batch_to_torch(batch, device=None):
    """A numpy batch (lists of arrays kept as lists) as tensors on
    `device` (the card unless the caller names another; raises without
    a card)."""
    import torch

    from .device import resolve_device

    device = resolve_device(device)

    def conv(v):
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)

    return {k: conv(v) for k, v in batch.items()}


def dn_bundle_from_numpy(tree, device=None):
    """A `DnBundle` from a mapping of numpy arrays (a JAX bundle's
    fields, for the tests), on `device` (the card unless the caller names
    another; raises without a card)."""
    import torch

    from ..training.targets3d import DnBundle
    from .device import resolve_device

    device = resolve_device(device)
    return DnBundle(**{k: torch.from_numpy(np.asarray(v).copy()).to(device)
                       for k, v in tree.items()})


def dn_state_from_numpy(tree, device=None):
    """A `DnState` from a mapping of numpy arrays, on `device` (the card
    unless the caller names another; raises without a card)."""
    import torch

    from ..training.dn import DnState
    from .device import resolve_device

    device = resolve_device(device)
    return DnState(**{k: torch.from_numpy(np.asarray(v).copy()).to(device)
                      for k, v in tree.items()})
