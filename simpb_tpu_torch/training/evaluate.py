"""Streaming evaluation: the cold and stream steps of the temporal stream,
and the loop that streams a sequence-aligned val shard through them and
scores it (port of `simpb_tpu/training/evaluate.py`: `_jitted_steps`
becomes `make_stream_steps`; `_stream_shard`, `_score` and
`streaming_eval` keep their names).

    cold_step, stream_step = make_stream_steps(model, cfg)
    decoded, state = cold_step(img, proj)
    decoded, state = stream_step(img, proj, state, dt, temp2cur)

    metrics, preds, tokens = streaming_eval(model, cfg, dataset)

The model holds its weights, so `streaming_eval` takes no separate
variables. Not ported yet (ROADMAP A.4, A.6): camera-axis sharding
(`cam_shards > 1`), rendering (`show_dir`), `multidevice_streaming_eval`
and `distributed_streaming_eval`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.decoder3d import decode_boxes3d
from ..models.instance_bank import TemporalState
from ..utils.guards import merge_guard_maxima, summarize_guards

Step = Callable[..., Tuple[Dict[str, torch.Tensor], TemporalState]]


def make_stream_steps(model, cfg: ModelConfig) -> Tuple[Step, Step]:
    """(cold_step, stream_step), each returning (decoded, temporal_state).

    cold_step(img, proj) starts a stream; stream_step(img, proj, state,
    time_interval, temp2cur) carries the instance bank. Both run on the
    model's device, in inference mode. Under `guard_sampling` the decode
    also holds each guard counter's maximum over the frame's layers as
    `guard_<name>`, broadcast to [bs] and left on the device."""

    def _apply(img, proj, **kw):
        with torch.inference_mode():
            out = model(img, proj, **kw)
            dec = decode_boxes3d(
                out["classification"][-1],
                out["prediction"][-1],
                instance_id=out.get("instance_id"),
                quality=out["quality"][-1],
                num_output=cfg.head.num_output,
                score_threshold=cfg.head.score_threshold,
            )
            bs = out["prediction"][-1].shape[0]
            for k, v in summarize_guards(out.get("guards") or {}).items():
                dec["guard_" + k] = v.expand(bs)
        return dec, out["temporal_state"]

    def cold_step(img, proj):
        return _apply(img, proj)

    def stream_step(img, proj, state, time_interval, temp2cur):
        return _apply(img, proj, temporal=state,
                      time_interval=time_interval, temp2cur=temp2cur)

    return cold_step, stream_step


def build_model(cfg: ModelConfig, device=None, seed: int = 0):
    """A SimPB model with seeded random weights and the synthetic
    anchors (`utils/synthetic.py`) on `device` (the card unless the
    caller names another), in eval mode."""
    from ..models.detector import SimPB
    from ..utils.device import resolve_device
    from ..utils.synthetic import randomize_

    dev = resolve_device(device)
    model = SimPB(cfg)
    randomize_(model, seed)
    return model.to(dev).eval()


def _decode_to_host(dec: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The first sample of a decode dict as numpy arrays, through one
    device-to-host copy: every tensor's bytes are packed into one buffer
    (widest element first, so each stays aligned), copied with one
    `.cpu()`, and split again. Floating outputs arrive as float32 (a
    bf16 head's are widened, which is exact)."""
    keys = sorted(dec, key=lambda k: -dec[k].element_size())
    rows = [dec[k][0].contiguous() for k in keys]
    host = torch.cat([r.reshape(-1).view(torch.uint8) for r in rows]).cpu()
    out, at = {}, 0
    for k, r in zip(keys, rows):
        n = r.numel() * r.element_size()
        t = host[at:at + n].view(r.dtype).reshape(r.shape)
        at += n
        out[k] = (t.float() if t.is_floating_point() else t).numpy()
    return out


def _stream_shard(
    model,
    cfg: ModelConfig,
    dataset,
    shard: List[int],
    progress: bool = False,
):
    """Stream one sequence-aligned shard; returns (preds, gts,
    scene_ids, tokens, guard_max) with boxes in the global frame and
    guard_max each `guard_*` counter's maximum over the frames."""
    from ..data.postprocess import boxes_lidar_to_global

    device = next(model.parameters()).device
    cold_step, stream_step = make_stream_steps(model, cfg)

    preds: List[dict] = []
    gts: List[dict] = []
    tokens: List[str] = []
    scene_ids: List[int] = []
    guard_max: Dict[str, float] = {}
    scene_no = 0
    state = None
    prev_ts = prev_t_global = None
    for n, idx in enumerate(shard):
        sample = dataset.get_sample(idx)
        img = torch.from_numpy(sample["img"][None]).to(device)
        proj = torch.from_numpy(sample["projection_mat"][None]).to(device)
        ts = sample["timestamp"]
        t_global = sample["lidar2global"]
        # scene boundary = the sequence_eval_shards timestamp-gap rule
        if prev_ts is not None and ts - prev_ts > 4.0:
            scene_no += 1
        scene_ids.append(scene_no)
        if state is None:
            dec, state = cold_step(img, proj)
        else:
            # unix-epoch arithmetic on the host, in float64, as in JAX
            dt = torch.tensor([ts - prev_ts], dtype=torch.float32,
                              device=device)
            t2c = torch.from_numpy(
                (np.linalg.inv(t_global) @ prev_t_global)[None]
                .astype(np.float32)).to(device)
            dec, state = stream_step(img, proj, state, dt, t2c)
        prev_ts, prev_t_global = ts, t_global

        dec = _decode_to_host(dec)
        guard_max = merge_guard_maxima(guard_max, {
            k: dec.pop(k) for k in list(dec) if k.startswith("guard_")})
        boxes_g = boxes_lidar_to_global(dec["boxes_3d"], t_global)
        valid = dec["valid"]
        # boxes are in the GLOBAL frame here: the class-range filter in
        # evaluate_detections needs the ego position (devkit measures
        # range as norm(box.translation - ego_pose.translation))
        ego_xy = sample["ego2global"][:2, 3].astype(np.float32)
        pred = {
            "boxes": boxes_g[valid],
            "scores": dec["scores_3d"][valid],
            "labels": dec["labels_3d"][valid],
            "ego_xy": ego_xy,
        }
        if "instance_ids" in dec:
            pred["track_ids"] = dec["instance_ids"][valid]
        preds.append(pred)
        tokens.append(dataset.data_infos[idx]["token"])
        gt = dataset.get_annotations(idx)
        gboxes = gt.get("gt_bboxes_3d", np.zeros((0, 9), np.float32))
        if len(gboxes):
            g10 = np.zeros((len(gboxes), 10), np.float32)
            g10[:, : gboxes.shape[1]] = gboxes
            g10 = boxes_lidar_to_global(g10, t_global)
        else:
            g10 = np.zeros((0, 10), np.float32)
        gt_d = {
            "boxes": g10,
            "labels": gt["gt_labels_3d"],
            "ego_xy": ego_xy,
        }
        if "gt_instance_id" in gt:
            gt_d["track_ids"] = np.asarray(gt["gt_instance_id"])
        gts.append(gt_d)

        if progress and (n + 1) % 100 == 0:
            print(f"{n + 1}/{len(shard)} frames", flush=True)

    return preds, gts, scene_ids, tokens, guard_max


def _score(preds, gts, scene_ids, tracking: bool) -> Dict[str, float]:
    from ..data.nuscenes_eval import evaluate_detections

    metrics = evaluate_detections(preds, gts)
    if tracking:
        have_ids = all(
            "track_ids" in p for p in preds
        ) and all("track_ids" in g for g in gts)
        if have_ids:
            from ..data.tracking_eval import evaluate_tracking

            metrics.update(evaluate_tracking(preds, gts, scene_ids))
        else:
            print(
                "tracking metrics skipped: instance ids missing from "
                "predictions or annotations"
            )
    return metrics


def streaming_eval(
    model,
    cfg: ModelConfig,
    dataset,
    max_frames: Optional[int] = None,
    show_dir: Optional[str] = None,
    progress: bool = False,
    tracking: bool = False,
    world_size: int = 1,
    rank: int = 0,
    cam_shards: int = 1,
) -> Tuple[Dict[str, float], List[dict], List[str]]:
    """Stream one shard of `dataset` through the model on its device and
    score it.

    Returns (metrics, per-frame predictions in global frame, tokens).
    The temporal instance bank threads frame to frame exactly like
    deployment streaming (reference tools/test.py:127-317). With
    `tracking=True` the decoder's persistent instance ids are scored
    with the native AMOTA/AMOTP evaluator (data/tracking_eval.py).
    `world_size`/`rank` select one sequence-aligned shard (metrics then
    cover that shard only). Under `guard_sampling` the metrics also hold
    each `guard_*` counter's maximum over the frames."""
    from ..data.sampler import sequence_eval_shards

    if cam_shards > 1:
        raise NotImplementedError(
            "cam_shards > 1 (camera-axis sharding) is not ported yet "
            "(ROADMAP A.4)"
        )
    if show_dir:
        raise NotImplementedError(
            "show_dir (rendering with data/visualize.py) is not ported "
            "yet (ROADMAP A.6)"
        )
    shard = sequence_eval_shards(dataset, world_size)[rank]
    if max_frames:
        shard = shard[:max_frames]
    preds, gts, scene_ids, tokens, guard_max = _stream_shard(
        model, cfg, dataset, shard, progress=progress,
    )
    metrics = _score(preds, gts, scene_ids, tracking)
    metrics.update(guard_max)
    return metrics, preds, tokens


def multidevice_streaming_eval(*args, **kwargs):
    """One sequence shard per local device: not ported yet."""
    raise NotImplementedError(
        "multidevice_streaming_eval is not ported yet (ROADMAP A.4)"
    )


def distributed_streaming_eval(*args, **kwargs):
    """Multi-process eval with a disk gather: not ported yet."""
    raise NotImplementedError(
        "distributed_streaming_eval is not ported yet (ROADMAP A.4)"
    )
