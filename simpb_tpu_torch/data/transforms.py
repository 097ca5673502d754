"""Host-side (numpy) image transforms of the test-mode pipeline
(port of the parts of `simpb_tpu/data/transforms.py` that
`NuScenesDataset.get_sample` calls in test mode): the resize / crop /
flip of one camera image with its intrinsic update, and the mean / std
normalisation. PIL is imported inside `img_transform`, the one function
that needs it. The training transforms (2D GT, photometric and 3D
augmentation, depth maps) come with the training path.
"""
from __future__ import annotations

from typing import Dict, List

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


def normalize_images(imgs: List[np.ndarray]) -> List[np.ndarray]:
    """to-RGB mean/std normalisation (config img_norm_cfg:320-322)."""
    return [(img - IMG_MEAN) / IMG_STD for img in imgs]
