"""Host-side result post-processing: boxes to the global frame and the
nuScenes submission (port of `simpb_tpu/data/postprocess.py`).

`format_nuscenes_submission` follows the reference `_format_bbox`
(nuscenes_dataset.py:504-586) with its attribute heuristic. The ragged
2D association of the JAX module (`associate_2d`, `unaugment_boxes2d`)
is not on the evaluation path and is not ported.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..configs.base import CLASS_NAMES

DEFAULT_ATTRIBUTES = {
    "car": "vehicle.parked",
    "truck": "vehicle.parked",
    "construction_vehicle": "vehicle.parked",
    "bus": "vehicle.parked",
    "trailer": "vehicle.parked",
    "barrier": "",
    "motorcycle": "cycle.without_rider",
    "bicycle": "cycle.without_rider",
    "pedestrian": "pedestrian.standing",
    "traffic_cone": "",
}


def attribute_for(class_name: str, velocity: np.ndarray) -> str:
    """Velocity-based attribute heuristic (reference
    nuscenes_dataset.py:553-576)."""
    speed = float(np.linalg.norm(velocity[:2]))
    if speed > 0.2:
        if class_name in (
            "car", "construction_vehicle", "bus", "truck", "trailer",
        ):
            return "vehicle.moving"
        if class_name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
    return DEFAULT_ATTRIBUTES.get(class_name, "")


# classes excluded from the nuScenes tracking benchmark; the reference
# skips them when formatting a tracking submission
# (nuscenes_dataset.py:524-529)
NON_TRACKING_CLASSES = ("barrier", "traffic_cone", "construction_vehicle")


def format_nuscenes_submission(
    results: List[Dict],
    sample_tokens: List[str],
    tracking: bool = False,
    tracking_threshold: float = 0.2,
) -> Dict:
    """Decoded per-sample results (numpy) -> nuScenes submission dict
    (reference _format_bbox, nuscenes_dataset.py:504-586); boxes already
    in the frame the caller wants them in (global for a submission).

    With `tracking=True`, emits the tracking-challenge schema instead
    (tracking_name/score/id; no detection keys), applying the
    reference's score threshold (0.2, nuscenes_dataset.py:90, 510-512)
    and skipping the non-tracking classes (:524-529). `instance_ids`
    must be present in each result."""
    annos = {}
    for res, token in zip(results, sample_tokens):
        boxes = np.asarray(res["boxes_3d"])
        scores = np.asarray(res["scores_3d"])
        labels = np.asarray(res["labels_3d"])
        valid = np.asarray(res.get("valid", np.ones(len(boxes), bool)))
        sample_annos = []
        for i in np.where(valid)[0]:
            name = CLASS_NAMES[int(labels[i])]
            box = boxes[i]
            yaw = box[6]
            # pure-Python floats: np.float32 scalars are not JSON
            # serializable
            quat = [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]
            anno = {
                "sample_token": token,
                "translation": box[:3].tolist(),
                "size": box[3:6].tolist(),
                "rotation": quat,
                "velocity": box[7:9].tolist(),
            }
            if tracking:
                if name in NON_TRACKING_CLASSES:
                    continue
                if float(scores[i]) < tracking_threshold:
                    continue
                anno["tracking_id"] = str(int(res["instance_ids"][i]))
                anno["tracking_name"] = name
                anno["tracking_score"] = float(scores[i])
            else:
                anno["detection_name"] = name
                anno["detection_score"] = float(scores[i])
                anno["attribute_name"] = attribute_for(name, box[7:9])
            sample_annos.append(anno)
        annos[token] = sample_annos
    return {
        "meta": {
            "use_camera": True,
            "use_lidar": False,
            "use_radar": False,
            "use_map": False,
            "use_external": False,
        },
        "results": annos,
    }


def boxes_lidar_to_global(
    boxes: np.ndarray, lidar2global: np.ndarray
) -> np.ndarray:
    """Decoded boxes [N, 10] from the lidar frame to global
    (reference lidar_nusc_box_to_global, nuscenes_dataset.py:858-899)."""
    out = boxes.copy()
    r = lidar2global[:3, :3]
    out[:, :3] = boxes[:, :3] @ r.T + lidar2global[:3, 3]
    yaw_global = np.arctan2(r[1, 0], r[0, 0])
    out[:, 6] = boxes[:, 6] + yaw_global
    vel = np.concatenate(
        [boxes[:, 7:9], np.zeros((len(boxes), 1))], axis=-1
    )
    out[:, 7:9] = (vel @ r.T)[:, :2]
    return out
