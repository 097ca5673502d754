"""Self-contained nuScenes tracking metrics (AMOTA / AMOTP / MOTA ...);
the port's copy of `simpb_tpu/data/tracking_eval.py`, numpy on the host.

The reference wires a tracking submission format and a devkit
TrackingEval call but short-circuits the tracking branch of
`evaluate()` (reference nuscenes_dataset.py:717-718 `## TODO`), so it
never actually scores tracks. This framework's streaming decoder
assigns persistent instance ids (reference instance_bank.py:169-196 →
models/instance_bank.py here), and this module scores them natively —
closing the one capability the reference leaves stubbed.

Implements the published nuScenes tracking benchmark definition
("tracking_nips_2019", AMOTA per Weng et al., "A Baseline for 3D
Multi-Object Tracking"), mirroring the devkit's
eval/tracking/algo.py + py-motmetrics semantics:

* 7 tracking classes (detection classes minus barrier / traffic_cone /
  construction_vehicle — the same set the reference's tracking
  submission formatter skips, nuscenes_dataset.py:524-529);
* per-class, per-scene frame-by-frame association with BEV center
  distance gated at 2 m: previous-frame correspondences are reused
  when still within the gate, the remainder is matched by a
  minimum-total-distance Hungarian assignment (py-motmetrics
  `MOTAccumulator.update` semantics, which the devkit delegates to);
* an ID switch is a match whose GT track's LAST KNOWN hypothesis id
  (persisting across occlusion gaps) differs; a fragmentation is an
  untracked gap strictly inside a GT track's tracked span;
* 40 recall thresholds linspace(0.1, 1): per-class score thresholds
  are interpolated from the threshold-free pass's matched-TP scores;
  MOTAR(r) = max(0, 1 − (IDS+FP+FN−(1−r)·P) / (r·P)) at each achieved
  threshold; unachieved recalls take the benchmark's worst values
  (MOTAR 0, MOTP 2.0 — devkit config `metric_worst`);
* AMOTA / AMOTP = mean over the 40 grid points; secondary CLEAR-MOT
  metrics (MOTA, MOTP, RECALL, IDS, FRAG, FP, FN, MT, ML) are reported
  at the per-class best-MOTAR threshold.

Cross-checked against an independent brute-force implementation
(permutation-enumerated assignment, naive event bookkeeping) in
tests/test_tracking_eval.py — the devkit itself is not installable in
this environment.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..configs.base import CLASS_NAMES
from .nuscenes_eval import CLASS_RANGE, filter_eval_boxes

TRACKING_CLASSES = (
    "bicycle",
    "bus",
    "car",
    "motorcycle",
    "pedestrian",
    "trailer",
    "truck",
)
TRACKING_CLASS_RANGE = {c: CLASS_RANGE[c] for c in TRACKING_CLASSES}
DIST_TH = 2.0  # BEV center-distance gate (devkit dist_th_tp)
MIN_RECALL = 0.1
NUM_THRESHOLDS = 40
MOTP_WORST = 2.0  # devkit tracking_nips_2019 metric_worst["motp"]


def _match_frame(
    gt_xy: np.ndarray,
    hyp_xy: np.ndarray,
    gt_ids: np.ndarray,
    hyp_ids: np.ndarray,
    last: Dict,
) -> List:
    """One frame of py-motmetrics association: reuse surviving
    previous correspondences first, Hungarian on the remainder.
    Returns [(gi, hi, dist)]."""
    n_g, n_h = len(gt_xy), len(hyp_xy)
    if n_g == 0 or n_h == 0:
        return []
    d = np.linalg.norm(gt_xy[:, None, :] - hyp_xy[None, :, :], axis=-1)
    gated = np.where(d <= DIST_TH, d, np.inf)

    matches = []
    used_g, used_h = set(), set()
    hyp_pos = {int(h): j for j, h in enumerate(hyp_ids)}
    for gi, gid in enumerate(gt_ids):
        prev = last.get(int(gid))
        if prev is None:
            continue
        hi = hyp_pos.get(prev)
        if hi is None or hi in used_h:
            continue
        if np.isfinite(gated[gi, hi]):
            matches.append((gi, hi, float(gated[gi, hi])))
            used_g.add(gi)
            used_h.add(hi)

    rem_g = [i for i in range(n_g) if i not in used_g]
    rem_h = [j for j in range(n_h) if j not in used_h]
    if rem_g and rem_h:
        from scipy.optimize import linear_sum_assignment

        sub = gated[np.ix_(rem_g, rem_h)]
        cost = np.where(np.isfinite(sub), sub, 1e9)
        rows, cols = linear_sum_assignment(cost)
        for r, c in zip(rows, cols):
            if np.isfinite(sub[r, c]):
                matches.append((rem_g[r], rem_h[c], float(sub[r, c])))
    return matches


def _accumulate(
    scenes: List[List[Dict]], threshold: Optional[float]
) -> Dict:
    """Accumulate CLEAR-MOT counts for one class at one score
    threshold (None = keep every prediction; used for the
    threshold-computation pass). `scenes`: per scene, per frame dicts
    with gt_xy/gt_ids/hyp_xy/hyp_ids/hyp_scores."""
    tp = fp = fn = ids = frag = 0
    motp_sum = 0.0
    match_scores: List[float] = []
    # per GT track: frames present / frames tracked / tracked pattern
    track_total: Dict = {}
    track_hit: Dict = {}
    track_pattern: Dict = {}

    for scene_no, scene in enumerate(scenes):
        last: Dict = {}  # gt id -> last known hyp id (persists)
        for frame in scene:
            g_xy, g_ids = frame["gt_xy"], frame["gt_ids"]
            h_xy, h_ids = frame["hyp_xy"], frame["hyp_ids"]
            h_sc = frame["hyp_scores"]
            if threshold is not None:
                keep = h_sc >= threshold
                h_xy, h_ids, h_sc = h_xy[keep], h_ids[keep], h_sc[keep]

            matches = _match_frame(g_xy, h_xy, g_ids, h_ids, last)
            matched_g = set()
            for gi, hi, dist in matches:
                gid, hid = int(g_ids[gi]), int(h_ids[hi])
                if gid in last and last[gid] != hid:
                    ids += 1
                last[gid] = hid
                tp += 1
                motp_sum += dist
                match_scores.append(float(h_sc[hi]))
                matched_g.add(gi)
            fn += len(g_ids) - len(matches)
            fp += len(h_ids) - len(matches)

            for gi, gid in enumerate(g_ids):
                # key per (scene, gt id): synthetic ids may repeat
                # across scenes (nuScenes instance ids never do)
                key = (scene_no, int(gid))
                track_total[key] = track_total.get(key, 0) + 1
                hit = gi in matched_g
                track_hit[key] = track_hit.get(key, 0) + int(hit)
                track_pattern.setdefault(key, []).append(hit)

    mt = ml = 0
    for key, pattern in track_pattern.items():
        # fragmentations: untracked runs strictly inside the tracked span
        hits = np.nonzero(pattern)[0]
        if hits.size:
            inner = pattern[hits[0] : hits[-1] + 1]
            frag += sum(
                1
                for i in range(1, len(inner))
                if inner[i] and not inner[i - 1]
            )
        ratio = track_hit[key] / track_total[key]
        mt += ratio >= 0.8
        ml += ratio <= 0.2

    return {
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "ids": ids,
        "frag": frag,
        "motp_sum": motp_sum,
        "match_scores": np.asarray(match_scores, np.float64),
        "mt": mt,
        "ml": ml,
    }


def _class_scenes(
    preds: List[Dict],
    gts: List[Dict],
    scene_ids: Sequence,
    cls_idx: int,
) -> List[List[Dict]]:
    """Group per-sample dicts into per-scene frame lists for one class."""
    scenes: Dict = {}
    order: List = []
    for pred, gt, sid in zip(preds, gts, scene_ids):
        gmask = gt["labels"] == cls_idx
        pmask = pred["labels"] == cls_idx
        frame = {
            "gt_xy": np.asarray(gt["boxes"][gmask, :2], np.float64),
            "gt_ids": np.asarray(gt["track_ids"][gmask], np.int64),
            "hyp_xy": np.asarray(pred["boxes"][pmask, :2], np.float64),
            "hyp_ids": np.asarray(pred["track_ids"][pmask], np.int64),
            "hyp_scores": np.asarray(pred["scores"][pmask], np.float64),
        }
        if sid not in scenes:
            scenes[sid] = []
            order.append(sid)
        scenes[sid].append(frame)
    return [scenes[s] for s in order]


def _recall_thresholds(
    match_scores: np.ndarray, num_gt: int
) -> np.ndarray:
    """Score thresholds achieving the 40-point recall grid (NaN where
    unachieved), interpolated from the threshold-free pass's matched
    scores (devkit TrackingEvaluation.compute_thresholds)."""
    grid = np.linspace(MIN_RECALL, 1.0, NUM_THRESHOLDS)
    out = np.full(NUM_THRESHOLDS, np.nan)
    if num_gt == 0 or match_scores.size == 0:
        return out
    scores = np.sort(match_scores)[::-1]
    recalls = np.arange(1, scores.size + 1) / num_gt
    achieved = grid <= recalls[-1] + 1e-9
    out[achieved] = np.interp(grid[achieved], recalls, scores)
    return out


def evaluate_tracking(
    preds: List[Dict],
    gts: List[Dict],
    scene_ids: Sequence,
    class_range: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Full nuScenes tracking scores.

    preds/gts: per-sample dicts with 'boxes' [N,>=7] decoded
    (x,y,z,w,l,h,yaw,...), 'scores' (preds only), 'labels',
    'track_ids', optionally 'ego_xy' for the range filter.
    scene_ids: per-sample scene key; samples must be in temporal order
    within each scene. Returns AMOTA/AMOTP (+ per-class
    `AMOTA_<class>`), and MOTA/MOTP/RECALL/IDS/FRAG/FP/FN/MT/ML at the
    per-class best-MOTAR thresholds.
    """
    if class_range is None:
        class_range = TRACKING_CLASS_RANGE
    keep_preds, keep_gts = [], []
    for p, g in zip(preds, gts):
        pm = np.isin(
            p["labels"],
            [CLASS_NAMES.index(c) for c in class_range],
        )
        gm = np.isin(
            g["labels"],
            [CLASS_NAMES.index(c) for c in class_range],
        )
        keep_preds.append(
            {
                k: (v[pm] if isinstance(v, np.ndarray)
                    and v.shape[:1] == pm.shape else v)
                for k, v in p.items()
            }
        )
        keep_gts.append(
            {
                k: (v[gm] if isinstance(v, np.ndarray)
                    and v.shape[:1] == gm.shape else v)
                for k, v in g.items()
            }
        )
    full_range = dict(CLASS_RANGE)
    full_range.update(class_range)
    preds = filter_eval_boxes(keep_preds, full_range)
    gts = filter_eval_boxes(keep_gts, full_range)

    amotas, amotps = {}, {}
    secondary = {
        k: [] for k in ("mota", "motp", "recall")
    }
    totals = {k: 0 for k in ("ids", "frag", "fp", "fn", "tp", "mt", "ml")}
    for cls in class_range:
        cls_idx = CLASS_NAMES.index(cls)
        scenes = _class_scenes(preds, gts, scene_ids, cls_idx)
        num_gt = sum(
            len(f["gt_ids"]) for scene in scenes for f in scene
        )
        if num_gt == 0:
            continue
        free = _accumulate(scenes, None)
        thresholds = _recall_thresholds(free["match_scores"], num_gt)

        motars = np.zeros(NUM_THRESHOLDS)
        motps = np.full(NUM_THRESHOLDS, MOTP_WORST)
        best = None  # ((mota, recall), counts, recall)
        for i, th in enumerate(thresholds):
            if np.isnan(th):
                continue
            acc = _accumulate(scenes, float(th))
            recall = acc["tp"] / num_gt
            if recall <= 0:
                continue
            motar = max(
                0.0,
                1.0
                - (acc["ids"] + acc["fp"] + acc["fn"] - (1 - recall) * num_gt)
                / (recall * num_gt),
            )
            motars[i] = motar
            motps[i] = (
                acc["motp_sum"] / acc["tp"] if acc["tp"] else MOTP_WORST
            )
            # secondary metrics are reported at the threshold maximising
            # MOTA (devkit convention); recall breaks ties
            mota = max(
                0.0, 1.0 - (acc["ids"] + acc["fp"] + acc["fn"]) / num_gt
            )
            if best is None or (mota, recall) > best[0]:
                best = ((mota, recall), acc, recall)

        amotas[cls] = float(motars.mean())
        amotps[cls] = float(motps.mean())
        if best is not None:
            (mota, _), acc, recall = best
            secondary["mota"].append(mota)
            secondary["motp"].append(
                acc["motp_sum"] / acc["tp"] if acc["tp"] else MOTP_WORST
            )
            secondary["recall"].append(recall)
            for k in ("ids", "frag", "fp", "fn", "tp", "mt", "ml"):
                totals[k] += acc[k]

    out: Dict[str, float] = {}
    if amotas:
        out["AMOTA"] = float(np.mean(list(amotas.values())))
        out["AMOTP"] = float(np.mean(list(amotps.values())))
        out["MOTA"] = float(np.mean(secondary["mota"]))
        out["MOTP"] = float(np.mean(secondary["motp"]))
        out["RECALL"] = float(np.mean(secondary["recall"]))
    else:
        out["AMOTA"] = float("nan")
        out["AMOTP"] = float("nan")
    for k in ("ids", "frag", "fp", "fn", "tp", "mt", "ml"):
        out[k.upper()] = float(totals[k])
    for cls, v in amotas.items():
        out[f"AMOTA_{cls}"] = v
        out[f"AMOTP_{cls}"] = amotps[cls]
    return out
