"""Detection rendering: camera projections + BEV (port of
`simpb_tpu/data/visualize.py`; numpy and OpenCV, the port's own copy).

Reference datasets/utils.py:10-224 (3D box corners, drawing on the
images and a BEV canvas) and the `show_results` video
(nuscenes_dataset.py:744-821). OpenCV (`cv2`) is imported inside the
functions that draw: the card's machine has none, and rendering without
it raises an ImportError that names cv2. `streaming_eval(show_dir=...)`
renders each frame and writes `detections.mp4`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# class colors (BGR)
PALETTE = [
    (255, 159, 10), (10, 132, 255), (48, 209, 88), (255, 69, 58),
    (191, 90, 242), (94, 92, 230), (255, 214, 10), (172, 142, 104),
    (100, 210, 255), (255, 55, 95),
]

EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
)


def box3d_corners(boxes: np.ndarray) -> np.ndarray:
    """Decoded boxes [N, >=7] -> [N, 8, 3] corners."""
    if len(boxes) == 0:
        return np.zeros((0, 8, 3))
    x = np.array([0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5])
    y = np.array([0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5])
    z = np.array([-0.5, -0.5, -0.5, -0.5, 0.5, 0.5, 0.5, 0.5])
    template = np.stack([x, y, z], -1)  # [8, 3]
    corners = template[None] * boxes[:, None, 3:6]
    yaw = boxes[:, 6]
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.zeros((len(boxes), 3, 3))
    rot[:, 0, 0], rot[:, 0, 1] = c, -s
    rot[:, 1, 0], rot[:, 1, 1] = s, c
    rot[:, 2, 2] = 1
    corners = np.einsum("nij,nkj->nki", rot, corners)
    return corners + boxes[:, None, :3]


def _cv2():
    """OpenCV, imported where a drawing needs it (the card's machine has
    none, and nothing else of the port needs it)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("rendering (show_dir) needs OpenCV: the cv2 "
                          "module is not installed") from e
    return cv2


def draw_boxes3d_on_image(
    img: np.ndarray,
    boxes: np.ndarray,
    lidar2img: np.ndarray,
    labels: Optional[np.ndarray] = None,
    thickness: int = 2,
) -> np.ndarray:
    """Project and draw wireframe boxes on one camera image."""
    cv2 = _cv2()
    img = img.copy()
    corners = box3d_corners(boxes)
    for i, cs in enumerate(corners):
        hom = np.concatenate([cs, np.ones((8, 1))], -1)
        proj = hom @ lidar2img.T
        depth = proj[:, 2]
        if (depth <= 0.1).all():
            continue
        uv = proj[:, :2] / np.maximum(depth[:, None], 1e-5)
        color = PALETTE[int(labels[i]) % len(PALETTE)] if labels is not None else (0, 255, 0)
        for a, b in EDGES:
            if depth[a] > 0.1 and depth[b] > 0.1:
                cv2.line(
                    img,
                    tuple(np.int32(uv[a])),
                    tuple(np.int32(uv[b])),
                    color,
                    thickness,
                )
    return img


def draw_boxes2d_on_image(
    img: np.ndarray,
    boxes_xyxy: np.ndarray,
    labels: Optional[np.ndarray] = None,
    scores: Optional[np.ndarray] = None,
) -> np.ndarray:
    cv2 = _cv2()
    img = img.copy()
    for i, b in enumerate(np.int32(boxes_xyxy)):
        color = PALETTE[int(labels[i]) % len(PALETTE)] if labels is not None else (0, 255, 0)
        cv2.rectangle(img, (b[0], b[1]), (b[2], b[3]), color, 2)
        if scores is not None:
            cv2.putText(
                img, f"{scores[i]:.2f}", (b[0], max(b[1] - 3, 0)),
                cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1,
            )
    return img


def draw_bev(
    boxes: np.ndarray,
    labels: Optional[np.ndarray] = None,
    canvas_size: int = 640,
    bev_range: float = 60.0,
) -> np.ndarray:
    """Top-down box footprint view (reference utils.py BEV canvas)."""
    cv2 = _cv2()
    canvas = np.zeros((canvas_size, canvas_size, 3), np.uint8)
    scale = canvas_size / (2 * bev_range)
    center = canvas_size // 2
    cv2.circle(canvas, (center, center), 4, (255, 255, 255), -1)
    corners = box3d_corners(boxes)[:, :4, :2]  # bottom face
    for i, cs in enumerate(corners):
        # image y axis points down; flip for ego-forward up
        pts = np.stack([center + cs[:, 0] * scale,
                        center - cs[:, 1] * scale], -1).astype(np.int32)
        color = PALETTE[int(labels[i]) % len(PALETTE)] if labels is not None else (0, 255, 0)
        cv2.polylines(canvas, [pts], True, color, 2)
    return canvas


def render_frame(
    imgs: Sequence[np.ndarray],
    result: Dict,
    lidar2imgs: Sequence[np.ndarray],
    score_threshold: float = 0.3,
) -> np.ndarray:
    """6-cam mosaic + BEV panel for one frame (reference
    nuscenes_dataset.py:744-821 layout: two rows of three cameras +
    BEV on the right)."""
    boxes = np.asarray(result["boxes_3d"])
    scores = np.asarray(result["scores_3d"])
    labels = np.asarray(result["labels_3d"])
    keep = scores >= score_threshold
    boxes, labels = boxes[keep], labels[keep]

    drawn = [
        draw_boxes3d_on_image(
            np.ascontiguousarray(img.astype(np.uint8)), boxes, l2i, labels
        )
        for img, l2i in zip(imgs, lidar2imgs)
    ]
    h, w = drawn[0].shape[:2]
    top = np.concatenate(drawn[:3], axis=1)
    bottom = np.concatenate(drawn[3:6], axis=1)
    mosaic = np.concatenate([top, bottom], axis=0)
    bev = draw_bev(boxes, labels, canvas_size=mosaic.shape[0])
    return np.concatenate([mosaic, bev], axis=1)


def write_video(frames: List[np.ndarray], path: str, fps: int = 10):
    """Frames (BGR uint8) -> an mp4v video at `path`."""
    cv2 = _cv2()
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for f in frames:
        vw.write(f)
    vw.release()
