"""Host-side (numpy) transforms of the data pipeline (port of
`simpb_tpu/data/transforms.py`): the resize / crop / flip of one camera
image with its intrinsic update, the 2D GT transform and occlusion
filter, the photometric distortion (its draws in the JAX package's order
on the caller's `np.random.Generator`), the mean / std normalisation,
the global 3D rotation and scale, the LiDAR depth maps, the yaw wrap and
the range filter. Everything stays numpy on the host. PIL is imported
inside `img_transform`, the one function that needs it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


def img_transform(img: np.ndarray, aug: Dict) -> tuple[np.ndarray, np.ndarray]:
    """Resize/crop/flip/rotate one image; returns (img, 4x4 intrinsic
    update matrix). Mirrors ResizeCropFlipImage._img_transform
    (reference pipelines/augment.py:86-132)."""
    from PIL import Image

    resize = aug.get("resize", 1.0)
    h, w = img.shape[:2]
    resize_dims = (int(w * resize), int(h * resize))
    crop = aug.get("crop", (0, 0, *resize_dims))
    flip = aug.get("flip", False)
    rotate = aug.get("rotate", 0)

    pil = Image.fromarray(np.uint8(np.clip(img, 0, 255)))
    pil = pil.resize(resize_dims).crop(crop)
    if flip:
        pil = pil.transpose(method=Image.FLIP_LEFT_RIGHT)
    if rotate:
        pil = pil.rotate(rotate)
    out = np.asarray(pil).astype(np.float32)

    mat = np.eye(3)
    mat[:2, :2] *= resize
    mat[:2, 2] -= np.array(crop[:2])
    if flip:
        fw = crop[2] - crop[0]
        mat = np.array([[-1, 0, fw], [0, 1, 0], [0, 0, 1]]) @ mat
    if rotate:
        r = np.deg2rad(rotate)
        rot = np.array(
            [[np.cos(r), np.sin(r), 0], [-np.sin(r), np.cos(r), 0], [0, 0, 1]]
        )
        center = np.array([crop[2] - crop[0], crop[3] - crop[1]]) / 2
        rot[:2, 2] = -rot[:2, :2] @ center + center
        mat = rot @ mat
    ext = np.eye(4)
    ext[:3, :3] = mat
    return out, ext


def transform_boxes2d(
    bboxes: np.ndarray,
    centers: np.ndarray,
    alphas: np.ndarray,
    aug: Dict,
    min_size: float = 2.0,
):
    """Transform per-camera 2D GT through the image augmentation.

    Mirrors ResizeCropFlipImage._bboxes_transform
    (reference pipelines/augment.py:134-203, released configs use
    rotate=0). Returns (bboxes, centers, alphas, keep_mask)."""
    resize = aug.get("resize", 1.0)
    crop = aug["crop"]
    flip = aug.get("flip", False)
    fh, fw = aug["final_dim"]

    b = bboxes * resize
    b[:, (0, 2)] -= crop[0]
    b[:, (1, 3)] -= crop[1]
    b[:, (0, 2)] = np.clip(b[:, (0, 2)], 0, fw)
    b[:, (1, 3)] = np.clip(b[:, (1, 3)], 0, fh)
    a = alphas.copy()
    if flip:
        x0, x1 = b[:, 0].copy(), b[:, 2].copy()
        b[:, 0], b[:, 2] = fw - x1, fw - x0
        neg = a < 0
        a[neg] = -a[neg] - np.pi
        a[~neg] = -a[~neg] + np.pi
    c = centers * resize
    c[:, 0] = np.clip(c[:, 0] - crop[0], 0, fw)
    c[:, 1] = np.clip(c[:, 1] - crop[1], 0, fh)
    if flip:
        c[:, 0] = fw - c[:, 0]
    keep = ((b[:, 2] - b[:, 0]) >= min_size) & ((b[:, 3] - b[:, 1]) >= min_size)
    return b, c, a, keep


def filter_occluded(bboxes, depths, fh, fw):
    """Occlusion filter: keep boxes still visible after z-ordered paint
    (reference pipelines/augment.py:205-232). Returns kept indices.

    Quirk replicated from the reference: the paint canvas starts as
    zeros and ranks start at 0, so rank 0 (the FARTHEST box) always
    appears in np.unique and survives even when fully overpainted
    (reference augment.py:208,224 has the same collision)."""
    n = len(bboxes)
    if n == 0:
        return np.zeros((0,), np.int64)
    idx_map = np.zeros((fh, fw), np.int64)
    tmp = np.zeros_like(bboxes)
    tmp[:, :2] = np.ceil(bboxes[:, :2])
    tmp[:, 2:] = np.floor(bboxes[:, 2:])
    tmp = tmp.astype(np.int64)
    order = np.argsort(-depths, kind="stable")
    for rank, i in enumerate(order):
        u1, v1, u2, v2 = tmp[i]
        idx_map[v1:v2, u1:u2] = rank
    visible_ranks = np.unique(idx_map)
    return order[visible_ranks]


def rgb_to_hsv(x: np.ndarray) -> np.ndarray:
    """Float RGB -> HSV with cv2's float32 conventions: H in [0, 360),
    S = diff/|V| (unclamped), V = max channel. Matches mmcv.bgr2hsv on
    the reference's BGR arrays (channel-order symmetric)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.max(x, axis=-1)
    mn = np.min(x, axis=-1)
    diff = v - mn
    s = diff / (np.abs(v) + np.finfo(np.float32).eps)
    dd = diff + np.finfo(np.float32).eps
    h = np.where(
        v == r,
        60.0 * (g - b) / dd,
        np.where(
            v == g, 120.0 + 60.0 * (b - r) / dd, 240.0 + 60.0 * (r - g) / dd
        ),
    )
    h = np.where(h < 0, h + 360.0, h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_rgb(x: np.ndarray) -> np.ndarray:
    """Inverse of `rgb_to_hsv` (cv2 float sector algorithm; S/V are not
    clamped, matching cv2's float path)."""
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    hp = (h / 60.0) % 6.0
    i = np.floor(hp)
    f = hp - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def _photometric_draws(rng: np.random.Generator):
    """One image's draws of `photometric_distortion`, in its order (a
    draw the branch before it skips is not made): (brightness delta,
    mode, contrast factor before HSV, saturation factor, hue delta,
    contrast factor after HSV, channel order); None where a step is not
    applied. The draws do not depend on the image."""
    bright = rng.uniform(-32, 32) if rng.integers(2) else None
    mode = rng.integers(2)
    contrast_pre = (rng.uniform(0.5, 1.5)
                    if mode == 1 and rng.integers(2) else None)
    sat = rng.uniform(0.5, 1.5) if rng.integers(2) else None
    hue = rng.uniform(-18, 18) if rng.integers(2) else None
    contrast_post = (rng.uniform(0.5, 1.5)
                     if mode == 0 and rng.integers(2) else None)
    perm = rng.permutation(3) if rng.integers(2) else None
    return bright, mode, contrast_pre, sat, hue, contrast_post, perm


def skip_photometric(rng: np.random.Generator, n_images: int) -> None:
    """Advance `rng` past `photometric_distortion`'s draws for
    `n_images` images without touching any image (a resumed training
    run replays the batches it skips this way)."""
    for _ in range(n_images):
        _photometric_draws(rng)


def photometric_distortion(
    rng: np.random.Generator, imgs: List[np.ndarray]
) -> List[np.ndarray]:
    """Exact reference photometric pipeline
    (pipelines/augment.py:309-413): per-IMAGE independent draws of
    brightness -> (contrast mode 0|1) -> HSV saturation -> HSV hue ->
    contrast -> random channel swap, each applied with p=0.5. The draws
    are the JAX package's, in its order (`_photometric_draws`)."""
    out = []
    for img in imgs:
        bright, mode, contrast_pre, sat, hue, contrast_post, perm = \
            _photometric_draws(rng)
        x = img.astype(np.float32)
        if bright is not None:
            x = x + bright
        if contrast_pre is not None:
            x = x * contrast_pre
        hsv = rgb_to_hsv(x)
        if sat is not None:
            hsv[..., 1] *= sat
        if hue is not None:
            hsv[..., 0] += hue
            hsv[..., 0][hsv[..., 0] > 360] -= 360
            hsv[..., 0][hsv[..., 0] < 0] += 360
        x = hsv_to_rgb(hsv)
        if contrast_post is not None:
            x = x * contrast_post
        if perm is not None:
            x = x[..., perm]
        out.append(x)
    return out


def normalize_images(imgs: List[np.ndarray]) -> List[np.ndarray]:
    """to-RGB mean/std normalisation (config img_norm_cfg:320-322)."""
    return [(img - IMG_MEAN) / IMG_STD for img in imgs]


def rotate_3d(sample: Dict, angle: float) -> Dict:
    """Global-frame 3D rotation augmentation (reference BBoxRotation,
    pipelines/augment.py:235-274): right-multiplies all lidar2x matrices
    by R^-1 and rotates boxes/velocities."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    )
    rot_inv = np.linalg.inv(rot)
    sample["lidar2img"] = [m @ rot_inv for m in sample["lidar2img"]]
    sample["extrinsics"] = [m @ rot_inv for m in sample["extrinsics"]]
    if "lidar2global" in sample:
        sample["lidar2global"] = sample["lidar2global"] @ rot_inv
    if "gt_bboxes_3d" in sample and len(sample["gt_bboxes_3d"]):
        box = sample["gt_bboxes_3d"]
        rt = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
        box[:, :3] = box[:, :3] @ rt
        box[:, 6] += angle
        if box.shape[-1] > 7:
            vd = box.shape[-1] - 7
            box[:, 7:] = box[:, 7:] @ rt[:vd, :vd]
    return sample


def scale_3d(sample: Dict, scale_ratio: float) -> Dict:
    """Global-frame 3D scale augmentation (reference BBoxScale,
    pipelines/augment.py:277-306): right-multiplies all lidar2x matrices
    by S^-1 and scales box centers/sizes/velocities (yaw untouched).
    Registered-but-unused in the released configs; provided for config
    parity."""
    s = float(scale_ratio)
    scale_inv = np.diag([1.0 / s, 1.0 / s, 1.0 / s, 1.0])
    sample["lidar2img"] = [m @ scale_inv for m in sample["lidar2img"]]
    sample["extrinsics"] = [m @ scale_inv for m in sample["extrinsics"]]
    if "lidar2global" in sample:
        sample["lidar2global"] = sample["lidar2global"] @ scale_inv
    if "gt_bboxes_3d" in sample and len(sample["gt_bboxes_3d"]):
        box = sample["gt_bboxes_3d"]
        box[:, :6] *= s
        box[:, 7:] *= s
    return sample


def depth_maps_from_points(
    points: np.ndarray,
    lidar2imgs: Sequence[np.ndarray],
    img_hw: tuple,
    strides: Sequence[int],
    max_depth: float = 60.0,
) -> List[np.ndarray]:
    """Render per-camera sparse depth maps at each stride
    (reference MultiScaleDepthMapGenerator, pipelines/transform.py:34-81).
    Unsupervised pixels get -1."""
    h, w = img_hw
    per_level = [[] for _ in strides]
    for l2i in lidar2imgs:
        pts = points[:, :3] @ l2i[:3, :3].T + l2i[:3, 3]
        z = pts[:, 2]
        uv = pts[:, :2] / np.maximum(z[:, None], 1e-5)
        u = np.round(uv[:, 0]).astype(np.int32)
        v = np.round(uv[:, 1]).astype(np.int32)
        m = (v >= 0) & (v < h) & (u >= 0) & (u < w) & (z >= 0.1)
        u, v, z = u[m], v[m], z[m]
        order = np.argsort(z)[::-1]
        u, v, z = u[order], v[order], z[order]
        z = np.clip(z, 0.1, max_depth)
        for j, stride in enumerate(strides):
            hh, ww = h // stride, w // stride
            dm = -np.ones((hh, ww), np.float32)
            dm[v // stride, u // stride] = z
            per_level[j].append(dm)
    return [np.stack(x) for x in per_level]


def limit_period(val, offset=0.5, period=2 * np.pi):
    """Yaw wrapping (reference NuScenesSparse4DAdaptor.limit_period)."""
    return val - np.floor(val / period + offset) * period


def circle_range_filter(boxes3d: np.ndarray, labels3d: np.ndarray,
                        dist_threshold: float = 55.0):
    """Per-class radial filter at 55 m (reference CircleObjectRangeFilter,
    pipelines/transform.py:187-226 with released thresholds)."""
    dist = np.linalg.norm(boxes3d[:, :2], axis=-1)
    return dist <= dist_threshold
