"""Self-contained nuScenes detection metrics (mAP / NDS); the port's
copy of `simpb_tpu/data/nuscenes_eval.py`, numpy on the host.

The reference delegates evaluation to the nuscenes-devkit
(nuscenes_dataset.py:588-742). That package is not part of this
framework's runtime deps, so the official metric definitions are
implemented here directly (host-side numpy):

* per-class, per-distance-threshold (0.5/1/2/4 m BEV center distance)
  greedy matching by descending score (devkit algo.py `accumulate`);
* 101-point recall-grid interpolation of precision / confidence /
  cumulative-mean TP errors (errors interpolated via the confidence
  values, exactly like the devkit);
* AP = mean of (precision - 0.1)+ over grid indices 11..100 / 0.9
  (devkit `calc_ap`);
* TP errors (ATE, ASE, AOE, AVE, AAE) = mean over grid indices
  11..max_recall_ind (devkit `calc_tp`); 1.0 below min recall;
* NDS = (5*mAP + sum over TP metrics of (1 - min(1, err))) / 10.

Cross-checked against an independent brute-force implementation of the
published definition in tests/test_nuscenes_eval_oracle.py (the devkit
itself is not installable in this environment).

Class conventions follow the devkit: barrier has period-pi orientation,
traffic_cone skips AOE/AVE/AAE, barrier skips AVE/AAE.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..configs.base import CLASS_NAMES

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1

# devkit detection_cvpr_2019 per-class eval range (m from ego);
# filter_eval_boxes drops GT and predictions beyond it. (The devkit
# additionally removes bicycles/motorcycles inside map bike racks —
# that needs the nuScenes map DB and is not replicated here.)
CLASS_RANGE = {
    "car": 50.0,
    "truck": 50.0,
    "construction_vehicle": 50.0,
    "bus": 50.0,
    "trailer": 50.0,
    "barrier": 30.0,
    "motorcycle": 40.0,
    "bicycle": 40.0,
    "pedestrian": 40.0,
    "traffic_cone": 30.0,
}


def filter_eval_boxes(
    samples: List[Dict], class_range: Dict[str, float]
) -> List[Dict]:
    """Devkit `filter_eval_boxes`: keep boxes whose BEV distance from
    the ego position is within the class-specific range (devkit uses
    `norm(ego_translation[:2])`). When a sample carries boxes in the
    GLOBAL frame it must provide `"ego_xy"` ([2], the ego position in
    that frame); without it the origin is assumed to BE the ego, i.e.
    boxes are in the per-sample ego/lidar frame."""
    out = []
    for s in samples:
        ego_xy = s.get("ego_xy")
        centers = s["boxes"][:, :2]
        if ego_xy is not None:
            centers = centers - np.asarray(ego_xy)[None, :]
        dist = np.linalg.norm(centers, axis=-1)
        limits = np.asarray(
            [class_range[CLASS_NAMES[int(l)]] for l in s["labels"]]
        ) if len(s["labels"]) else np.zeros(0)
        keep = dist <= limits
        filtered = {
            # per-box arrays filter; metadata (ego_xy, token, ...) passes
            k: (v[keep] if k != "ego_xy" and isinstance(v, np.ndarray) and
                v.shape[:1] == keep.shape else v)
            for k, v in s.items()
        }
        out.append(filtered)
    return out

ATTR_CLASSES = set(CLASS_NAMES) - {"traffic_cone", "barrier"}
VEL_CLASSES = set(CLASS_NAMES) - {"traffic_cone", "barrier"}
ORIENT_CLASSES = set(CLASS_NAMES) - {"traffic_cone"}
PERIOD_PI_CLASSES = {"barrier"}


def _yaw_diff(a, b, period=2 * np.pi):
    d = (a - b) % period
    return np.minimum(d, period - d)


def _size_iou(pred_wlh, gt_wlh):
    """Aligned 3D IoU of size-only boxes (devkit scale_iou)."""
    inter = np.prod(np.minimum(pred_wlh, gt_wlh), axis=-1)
    union = (
        np.prod(pred_wlh, axis=-1) + np.prod(gt_wlh, axis=-1) - inter
    )
    return inter / np.maximum(union, 1e-8)


def accumulate_class(
    preds: List[Dict],
    gts: List[Dict],
    class_name: str,
    dist_th: float,
):
    """Greedy center-distance matching for one class/threshold across all
    samples. preds/gts: per-sample dicts with keys
    'boxes' [N, 10] decoded (x,y,z,w,l,h,yaw,vx,vy[,vz]), 'scores',
    'labels', optionally 'attrs'. Returns (tp, fp, scores, match_errors
    dict lists, num_gt)."""
    cls_idx = CLASS_NAMES.index(class_name)
    all_scores, all_tp, all_fp = [], [], []
    err_trans, err_scale, err_orient, err_vel, err_attr = [], [], [], [], []
    num_gt = 0

    for pred, gt in zip(preds, gts):
        gmask = gt["labels"] == cls_idx
        gboxes = gt["boxes"][gmask]
        gattrs = gt.get("attrs")
        gattrs = gattrs[gmask] if gattrs is not None else None
        num_gt += len(gboxes)
        pmask = pred["labels"] == cls_idx
        pboxes = pred["boxes"][pmask]
        pscores = pred["scores"][pmask]
        pattrs = pred.get("attrs")
        pattrs = pattrs[pmask] if pattrs is not None else None

        order = np.argsort(-pscores)
        taken = np.zeros(len(gboxes), bool)
        for pi in order:
            all_scores.append(pscores[pi])
            if len(gboxes) == 0:
                all_tp.append(0.0)
                all_fp.append(1.0)
                continue
            d = np.linalg.norm(
                gboxes[:, :2] - pboxes[pi, :2][None], axis=-1
            )
            d = np.where(taken, np.inf, d)
            gi = int(np.argmin(d))
            if d[gi] < dist_th:
                taken[gi] = True
                all_tp.append(1.0)
                all_fp.append(0.0)
                err_trans.append(float(d[gi]))
                err_scale.append(
                    1.0 - float(_size_iou(pboxes[pi, 3:6], gboxes[gi, 3:6]))
                )
                period = (
                    np.pi if class_name in PERIOD_PI_CLASSES else 2 * np.pi
                )
                err_orient.append(
                    float(_yaw_diff(pboxes[pi, 6], gboxes[gi, 6], period))
                )
                err_vel.append(
                    float(
                        np.linalg.norm(pboxes[pi, 7:9] - gboxes[gi, 7:9])
                    )
                )
                if pattrs is not None and gattrs is not None:
                    err_attr.append(float(pattrs[pi] != gattrs[gi]))
                else:
                    err_attr.append(0.0)
            else:
                all_tp.append(0.0)
                all_fp.append(1.0)

    return {
        "scores": np.asarray(all_scores),
        "tp": np.asarray(all_tp),
        "fp": np.asarray(all_fp),
        "trans": np.asarray(err_trans),
        "scale": np.asarray(err_scale),
        "orient": np.asarray(err_orient),
        "vel": np.asarray(err_vel),
        "attr": np.asarray(err_attr),
        "num_gt": num_gt,
    }


def metric_data(acc) -> Optional[Dict[str, np.ndarray]]:
    """Devkit `DetectionMetricData`: precision / confidence / cumulative-
    mean TP errors interpolated onto the 101-point recall grid
    (devkit eval/detection/algo.py `accumulate`).

    Returns None when the class has no GT (excluded from means).
    """
    if acc["num_gt"] == 0:
        return None
    grid = np.linspace(0, 1, 101)
    n_pred = len(acc["scores"])
    md = {
        "precision": np.zeros(101),
        "confidence": np.zeros(101),
    }
    err_keys = ("trans", "scale", "orient", "vel", "attr")
    if n_pred == 0 or acc["tp"].sum() == 0:
        # devkit MetricData.no_predictions: zero precision, unit errors
        for k in err_keys:
            md[k] = np.ones(101)
        return md
    order = np.argsort(-acc["scores"], kind="stable")
    tp = np.cumsum(acc["tp"][order])
    fp = np.cumsum(acc["fp"][order])
    conf = acc["scores"][order]
    recall = tp / acc["num_gt"]
    precision = tp / (tp + fp)
    md["precision"] = np.interp(grid, recall, precision, right=0)
    md["confidence"] = np.interp(grid, recall, conf, right=0)
    # cumulative-mean errors over matches (score-desc), interpolated by
    # CONFIDENCE (devkit interpolates error-vs-match-conf at the grid's
    # confidence values, not directly on recall)
    match_mask = acc["tp"] > 0
    match_conf = acc["scores"][match_mask]
    eorder = np.argsort(-match_conf, kind="stable")
    match_conf = match_conf[eorder]
    for k in err_keys:
        errs = acc[k][eorder]
        cum_mean = np.cumsum(errs) / np.arange(1, len(errs) + 1)
        md[k] = np.interp(
            md["confidence"][::-1], match_conf[::-1], cum_mean[::-1]
        )[::-1]
    return md


def _average_precision(md) -> float:
    """Devkit calc_ap: mean of (precision - 0.1)+ over recall grid
    indices 11..100, normalised by (1 - min_precision)."""
    if md is None:
        return float("nan")
    prec = np.copy(md["precision"])[round(100 * MIN_RECALL) + 1 :]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def _tp_error(md, key) -> float:
    """Devkit calc_tp: mean error over grid indices 11..max_recall_ind
    (the last grid point with nonzero confidence); 1.0 when the class
    achieves less than min recall."""
    if md is None:
        return float("nan")
    nz = np.nonzero(md["confidence"])[0]
    max_recall_ind = int(nz[-1]) if nz.size else 0
    first_ind = round(100 * MIN_RECALL) + 1
    if max_recall_ind < first_ind:
        return 1.0
    return float(np.mean(md[key][first_ind : max_recall_ind + 1]))


def evaluate_detections(
    preds: List[Dict],
    gts: List[Dict],
    class_range: Optional[Dict[str, float]] = CLASS_RANGE,
) -> Dict[str, float]:
    """Full nuScenes detection scores.

    Applies the devkit's per-class range filter by default (pass
    class_range=None for unfiltered matching math). Returns dict with
    mAP, NDS, mATE/mASE/mAOE/mAVE/mAAE, and per-class AP
    (`AP_<class>`)."""
    if class_range is not None:
        preds = filter_eval_boxes(preds, class_range)
        gts = filter_eval_boxes(gts, class_range)
    aps = {}
    tp_errs = {k: {} for k in ("trans", "scale", "orient", "vel", "attr")}
    for cls in CLASS_NAMES:
        cls_aps = []
        for th in DIST_THRESHOLDS:
            acc = accumulate_class(preds, gts, cls, th)
            md = metric_data(acc)
            cls_aps.append(_average_precision(md))
            if th == TP_THRESHOLD:
                tp_errs["trans"][cls] = _tp_error(md, "trans")
                tp_errs["scale"][cls] = _tp_error(md, "scale")
                tp_errs["orient"][cls] = (
                    _tp_error(md, "orient")
                    if cls in ORIENT_CLASSES
                    else float("nan")
                )
                tp_errs["vel"][cls] = (
                    _tp_error(md, "vel")
                    if cls in VEL_CLASSES
                    else float("nan")
                )
                tp_errs["attr"][cls] = (
                    _tp_error(md, "attr")
                    if cls in ATTR_CLASSES
                    else float("nan")
                )
        aps[cls] = float(np.nanmean(cls_aps))

    mean_ap = float(np.nanmean([v for v in aps.values()]))
    out = {"mAP": mean_ap}
    tp_names = {
        "trans": "mATE",
        "scale": "mASE",
        "orient": "mAOE",
        "vel": "mAVE",
        "attr": "mAAE",
    }
    nds_terms = [5 * mean_ap]
    for k, name in tp_names.items():
        vals = [v for v in tp_errs[k].values() if not np.isnan(v)]
        err = float(np.mean(vals)) if vals else 1.0
        out[name] = err
        nds_terms.append(max(0.0, 1.0 - min(1.0, err)))
    out["NDS"] = float(sum(nds_terms) / 10.0)
    for cls, ap in aps.items():
        out[f"AP_{cls}"] = ap
    return out
