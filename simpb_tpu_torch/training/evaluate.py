"""Streaming evaluation: the cold and stream steps of the temporal stream,
and the loop that streams a sequence-aligned val shard through them and
scores it (port of `simpb_tpu/training/evaluate.py`: `_jitted_steps`
becomes `make_stream_steps`; `_stream_shard`, `_score` and
`streaming_eval` keep their names).

    cold_step, stream_step = make_stream_steps(model, cfg)
    decoded, state = cold_step(img, proj)
    decoded, state = stream_step(img, proj, state, dt, temp2cur)

    metrics, preds, tokens = streaming_eval(model, cfg, dataset)

The model holds its weights, so the evals take no separate variables.
`multidevice_streaming_eval` streams several sequence shards as the
slots of one batch (slots that share a card run as one batch there);
`distributed_streaming_eval` streams one shard a process and gathers
the parts on disk for rank 0 to score. `streaming_eval(show_dir=...)`
renders each frame (`data/visualize.py`, host-side OpenCV) and writes
`detections.mp4` there. Not ported yet: camera-axis sharding
(`cam_shards > 1`, ROADMAP A.5).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import copy
import os
import pickle

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.decoder3d import decode_boxes3d
from ..models.instance_bank import TemporalState
from ..parallel.mesh import host_barrier, process_count, process_index
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


def _decode_batch_to_host(dec: Dict[str, torch.Tensor]
                          ) -> Dict[str, np.ndarray]:
    """A decode dict as numpy arrays (the batch axis kept), through one
    device-to-host copy: every tensor's bytes are packed into one buffer
    (widest element first, so each stays aligned), copied with one
    `.cpu()`, and split again. Floating outputs arrive as float32 (a
    bf16 head's are widened, which is exact)."""
    keys = sorted(dec, key=lambda k: -dec[k].element_size())
    # a dense copy each: a guard maximum is broadcast to [bs] (stride 0)
    rows = [dec[k].clone(memory_format=torch.contiguous_format)
            for k in keys]
    host = torch.cat([r.reshape(-1).view(torch.uint8) for r in rows]).cpu()
    out, at = {}, 0
    for k, r in zip(keys, rows):
        n = r.numel() * r.element_size()
        t = host[at:at + n].view(r.dtype).reshape(r.shape)
        at += n
        out[k] = (t.float() if t.is_floating_point() else t).numpy()
    return out


def _decode_to_host(dec: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The first sample of a decode dict as numpy arrays (one copy)."""
    first = _decode_batch_to_host({k: v[:1] for k, v in dec.items()})
    return {k: v[0] for k, v in first.items()}


def _host_prediction(dataset, idx, sample, dec):
    """One frame's (prediction, ground truth) in the global frame from its
    decode (numpy, one sample)."""
    from ..data.postprocess import boxes_lidar_to_global

    t_global = sample["lidar2global"]
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
    return pred, gt_d


def _stream_shard(
    model,
    cfg: ModelConfig,
    dataset,
    shard: List[int],
    progress: bool = False,
    show_dir: Optional[str] = None,
    show_threshold: float = 0.3,
):
    """Stream one sequence-aligned shard; returns (preds, gts,
    scene_ids, tokens, guard_max) with boxes in the global frame and
    guard_max each `guard_*` counter's maximum over the frames. With
    `show_dir`, each frame's detections above `show_threshold` are drawn
    on its six images and a BEV panel, and the frames written to
    `<show_dir>/detections.mp4`."""
    device = next(model.parameters()).device
    cold_step, stream_step = make_stream_steps(model, cfg)

    preds: List[dict] = []
    gts: List[dict] = []
    tokens: List[str] = []
    scene_ids: List[int] = []
    guard_max: Dict[str, float] = {}
    scene_no = 0
    vis_frames: List[np.ndarray] = []
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
        pred, gt_d = _host_prediction(dataset, idx, sample, dec)
        preds.append(pred)
        gts.append(gt_d)
        tokens.append(dataset.data_infos[idx]["token"])

        if show_dir:
            from ..data.transforms import IMG_MEAN, IMG_STD
            from ..data.visualize import render_frame

            frame = render_frame(
                list(sample["img"] * IMG_STD + IMG_MEAN),
                {k: dec[k] for k in ("boxes_3d", "scores_3d", "labels_3d")},
                list(sample["projection_mat"]),
                score_threshold=show_threshold,
            )
            vis_frames.append(frame[..., ::-1])  # RGB -> BGR for cv2

        if progress and (n + 1) % 100 == 0:
            print(f"{n + 1}/{len(shard)} frames", flush=True)

    if show_dir and vis_frames:
        from ..data.visualize import write_video

        os.makedirs(show_dir, exist_ok=True)
        write_video(vis_frames, os.path.join(show_dir, "detections.mp4"))
        print(f"wrote {len(vis_frames)}-frame video to {show_dir}")

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
    show_threshold: float = 0.3,
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
    each `guard_*` counter's maximum over the frames. `show_dir`:
    render the frames there (`_stream_shard`; needs OpenCV)."""
    from ..data.sampler import sequence_eval_shards

    if cam_shards > 1:
        raise NotImplementedError(
            "cam_shards > 1 (camera-axis sharding: one stream's cameras "
            "over several cards) is not ported yet (ROADMAP A.5)"
        )
    shard = sequence_eval_shards(dataset, world_size)[rank]
    if max_frames:
        shard = shard[:max_frames]
    preds, gts, scene_ids, tokens, guard_max = _stream_shard(
        model, cfg, dataset, shard, progress=progress, show_dir=show_dir,
        show_threshold=show_threshold,
    )
    metrics = _score(preds, gts, scene_ids, tracking)
    metrics.update(guard_max)
    return metrics, preds, tokens


def _indexed(device) -> torch.device:
    """`device` with the current card's index where it names none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def multidevice_streaming_eval(
    model,
    cfg: ModelConfig,
    dataset,
    max_frames: Optional[int] = None,
    progress: bool = False,
    tracking: bool = False,
    devices: Optional[Sequence] = None,
) -> Tuple[Dict[str, float], List[dict], List[str]]:
    """One process, several sequence shards as the slots of a batch:
    `devices` holds one torch device a slot (default: every card), and
    the slots that share a device run as one batch there (so
    `["cuda:0"] * 4` serves bs 4 on one card). Each device gets a copy
    of `model`.

    Each shard starts with a cold instance bank, as one rank of the
    reference's dist_test.sh. Scene boundaries inside a shard go through
    the per-sample |dt| > max_time_interval mask, as in bs 1 streaming;
    a shard that has ended re-feeds its last frame and its predictions
    are dropped. With fewer scenes than slots the slots shrink to the
    scenes; `max_frames` is the total, split over the shards. Every
    device's step is enqueued before any result is read. Returns
    `streaming_eval`'s (metrics, preds, tokens), frames shard-major, each
    frame's decode that of streaming its shard alone at bs 1."""
    from ..data.sampler import sequence_eval_shards

    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_indexed(d) for d in devices]
    n = len(devices)
    if n == 1:
        return streaming_eval(model, cfg, dataset, max_frames=max_frames,
                              progress=progress, tracking=tracking)
    shards = sequence_eval_shards(dataset, n)
    n_eff = sum(1 for sh in shards if sh)
    if n_eff < n:
        # fewer scenes than slots: no slot streams an empty shard
        devices, n = devices[:n_eff], n_eff
        shards = sequence_eval_shards(dataset, n)
        if n == 1:
            return streaming_eval(model, cfg, dataset,
                                  max_frames=max_frames, progress=progress,
                                  tracking=tracking)
    if max_frames:
        per_shard = -(-max_frames // n)  # the total budget, split
        shards = [sh[:per_shard] for sh in shards]
    length = max(len(sh) for sh in shards)

    # the slots of each device, in slot order; a model and steps each
    home = _indexed(next(model.parameters()).device)
    groups: Dict[torch.device, List[int]] = {}
    for slot, dev in enumerate(devices):
        groups.setdefault(dev, []).append(slot)
    steps = {}
    for dev in groups:
        replica = model if dev == home else copy.deepcopy(model).to(dev)
        steps[dev] = make_stream_steps(replica, cfg)

    per_shard: List[list] = [[] for _ in range(n)]
    guard_max: Dict[str, float] = {}
    prev_ts: List[Optional[float]] = [None] * n
    prev_tg: List[Optional[np.ndarray]] = [None] * n
    scene_no = [0] * n
    last: List[Optional[dict]] = [None] * n
    states: Dict[torch.device, object] = {dev: None for dev in groups}
    for t in range(length):
        for s in range(n):
            if t < len(shards[s]):
                last[s] = dataset.get_sample(shards[s][t])
            # else: an ended shard re-feeds its last frame
        decs = {}
        for dev, slots in groups.items():
            img = torch.from_numpy(np.stack(
                [last[s]["img"] for s in slots])).to(dev)
            proj = torch.from_numpy(np.stack(
                [last[s]["projection_mat"] for s in slots]).astype(
                    np.float32)).to(dev)
            cold_step, stream_step = steps[dev]
            if states[dev] is None:
                decs[dev], states[dev] = cold_step(img, proj)
            else:
                # unix-epoch arithmetic on the host, in float64
                dt = np.array([last[s]["timestamp"] - prev_ts[s]
                               for s in slots], np.float32)
                t2c = np.stack([np.linalg.inv(last[s]["lidar2global"])
                                @ prev_tg[s] for s in slots]).astype(
                                    np.float32)
                decs[dev], states[dev] = stream_step(
                    img, proj, states[dev], torch.from_numpy(dt).to(dev),
                    torch.from_numpy(t2c).to(dev))
        # every device's step is queued; now read the results
        for dev, slots in groups.items():
            dec = _decode_batch_to_host(decs[dev])
            guard_max = merge_guard_maxima(guard_max, {
                k: dec.pop(k).max() for k in list(dec)
                if k.startswith("guard_")})
            for j, s in enumerate(slots):
                live = t < len(shards[s])
                sm = last[s]
                if live and prev_ts[s] is not None and \
                        sm["timestamp"] - prev_ts[s] > 4.0:
                    scene_no[s] += 1
                prev_ts[s], prev_tg[s] = sm["timestamp"], sm["lidar2global"]
                if not live:
                    continue
                idx = shards[s][t]
                pred, gt_d = _host_prediction(
                    dataset, idx, sm, {k: v[j] for k, v in dec.items()})
                per_shard[s].append((pred, gt_d, (s, scene_no[s]),
                                     dataset.data_infos[idx]["token"]))
        if progress and (t + 1) % 100 == 0:
            print(f"{t + 1}/{length} frames x {n} slots", flush=True)

    preds, gts, scene_keys, tokens = [], [], [], []
    for rows in per_shard:  # shard-major, as the rank-ordered merge
        for pred, gt_d, key, token in rows:
            preds.append(pred)
            gts.append(gt_d)
            scene_keys.append(key)
            tokens.append(token)
    metrics = _score(preds, gts, scene_keys, tracking)
    metrics.update(guard_max)
    return metrics, preds, tokens


def distributed_streaming_eval(
    model,
    cfg: ModelConfig,
    dataset,
    tmpdir: str,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    max_frames: Optional[int] = None,
    progress: bool = False,
    tracking: bool = False,
) -> Optional[Tuple[Dict[str, float], List[dict], List[str]]]:
    """Multi-process eval with the reference's disk gather: each process
    streams its sequence-aligned shard, writes `part_{rank}.pkl` to the
    shared `tmpdir` (to a temporary name, then renamed), waits for the
    others, and rank 0 concatenates the parts in rank order (shards hold
    whole scenes), max-merges their guard maxima and scores the whole
    set. Returns (metrics, preds, tokens) on rank 0, None elsewhere.
    `world_size` / `rank` default to the process group's; pass them to
    drive the shards one by one in a single process (no barrier then:
    call rank 0 last)."""
    from ..data.sampler import sequence_eval_shards

    if world_size is None:
        world_size = process_count()
    if rank is None:
        rank = process_index()
    shard = sequence_eval_shards(dataset, world_size)[rank]
    if max_frames:
        shard = shard[:max_frames]
    preds, gts, scene_ids, tokens, guard_max = _stream_shard(
        model, cfg, dataset, shard, progress=progress)
    os.makedirs(tmpdir, exist_ok=True)
    part = os.path.join(tmpdir, f"part_{rank}.pkl")
    with open(part + ".tmp", "wb") as f:
        pickle.dump({
            "preds": preds,
            "gts": gts,
            # scene keys stay distinct across ranks
            "scene_ids": [(rank, s) for s in scene_ids],
            "tokens": tokens,
            "guard_max": guard_max,
        }, f)
    os.replace(part + ".tmp", part)
    host_barrier("simpb_eval_gather")
    if rank != 0:
        return None

    all_preds: List[dict] = []
    all_gts: List[dict] = []
    all_scenes: List = []
    all_tokens: List[str] = []
    all_guards: Dict[str, float] = {}
    for r in range(world_size):
        # the parts this run's ranks wrote, read back
        with open(os.path.join(tmpdir, f"part_{r}.pkl"), "rb") as f:
            payload = pickle.load(f)
        all_preds.extend(payload["preds"])
        all_gts.extend(payload["gts"])
        all_scenes.extend(payload["scene_ids"])
        all_tokens.extend(payload["tokens"])
        all_guards = merge_guard_maxima(all_guards, payload["guard_max"])
    metrics = _score(all_preds, all_gts, all_scenes, tracking)
    metrics.update(all_guards)
    return metrics, all_preds, all_tokens
