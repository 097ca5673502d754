"""Training CLI (port of the repository's `tools/train.py`).

Builds the training dataset and the streaming sampler, the training
model and its state on the card, and runs the iteration loop: a
producer thread assembles the next batches on the host (two deep) while
the card runs the step; periodic logging, checkpoints
(`training/checkpoint.py`), the mid-training eval with `ckpt_best` on
NDS, the SIGTERM / SIGUSR1 preemption checkpoint and the preemption
watchdog (`utils/watchdog.py`). The temporal state threads across
iterations as the reference's IterBasedRunner threads it over the
GroupInBatchSampler stream.

Usage:
  python -m simpb_tpu_torch.tools.train \\
      --ann-file data/nuscenes/simpb_nuscenes_infos_train.pkl \\
      --config r50 [--work-dir work_dirs/simpb_r50] [--max-iters N] \\
      [--eval-ann-file val.pkl] [--resume-from work_dirs/.../ckpt_1000] \\
      [--device cpu]

The flags, names and defaults are the JAX CLI's, plus `--device` (the
card unless given). `--bf16` is on, as there: the trunk computes in
bf16, the head in fp32. The step is `training/train_step.py::
build_train_step`; its seed is `--seed`, and so are the photometric
generator's and the sampler's (each its own generator, as in JAX).

Refused with "not ported" (ROADMAP.md): `--multihost`, `--coordinator`,
`--num-processes` and `--process-id` (data-parallel training, A.4);
`--img-bf16` (a workaround of the TPU host link, not ported); the
configs the port does not train yet (`r101`: ResNet-101, A.5;
`r101-fast`: `stem_s2d`, A.5), before any model is built. `--config r50`
(the default) is the released recipe with exact MSDA, `r50-fast` the
windowed one; `--config tiny` is JAX's tiny config, exact MSDA.

`run(args, dataset=None, eval_dataset=None)` runs a parsed command line
and returns what it measured (losses, step, producer and queue-wait
times, checkpoint times and sizes, the eval's metrics, the final state);
a caller may pass its own datasets. A resumed run replays the skipped
iterations' sampler and photometric draws without loading a frame, so
its batches equal the uninterrupted run's (the JAX CLI restarts the
photometric generator on resume).
"""
import argparse
import dataclasses
import os
import queue
import signal
import threading
import time

import numpy as np

NOT_PORTED_CONFIGS = {
    "r101": "ResNet-101 (ROADMAP A.5)",
    "r101-fast": "stem_s2d (ROADMAP A.5)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann-file", required=True)
    p.add_argument("--data-root", default="")
    p.add_argument("--config", default="r50",
                   choices=["r50", "r50-fast", "r101", "r101-fast",
                            "tiny"])
    p.add_argument("--work-dir", default="work_dirs/simpb_tpu")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--ckpt-interval", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--src-h", type=int, default=900)
    p.add_argument("--src-w", type=int, default=1600)
    p.add_argument("--draft-decode", action="store_true",
                   help="DCT-domain scaled JPEG decode (libjpeg n/8 via "
                        "PIL draft) when the scale divides the source "
                        "dims exactly")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="trunk in bf16, head in fp32 (always on)")
    p.add_argument("--img-bf16", action="store_true", help="not ported")
    p.add_argument("--load-from", default=None,
                   help="reference torch .pth to initialise from")
    p.add_argument("--pretrained-backbone", default=None,
                   help="ImageNet-pretrained ResNet .pth (torchvision or "
                        "mmdet naming) to initialise the backbone only")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint of this trainer to resume from")
    p.add_argument("--anchors", default=None,
                   help="k-means anchor .npy (reference "
                        "nuscenes_kmeans900.npy)")
    p.add_argument("--eval-ann-file", default=None,
                   help="val pkl: run the mid-training eval")
    p.add_argument("--eval-interval", type=int, default=20000)
    p.add_argument("--eval-frames", type=int, default=500,
                   help="cap on mid-training eval frames")
    p.add_argument("--multihost", action="store_true", help="not ported")
    p.add_argument("--coordinator", default=None, help="not ported")
    p.add_argument("--num-processes", type=int, default=None,
                   help="not ported")
    p.add_argument("--process-id", type=int, default=None,
                   help="not ported")
    p.add_argument("--watchdog-deadline", type=float, default=120.0,
                   help="seconds a termination signal may wait on a main "
                        "thread stuck in a native call before the "
                        "watchdog forces a resumable exit (code 75, "
                        "resume from the last checkpoint); 0 disables")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def refused_flags(args):
    """The flags given that the port does not serve yet."""
    refused = [flag for flag, given in (
        ("--multihost", args.multihost),
        ("--coordinator", args.coordinator is not None),
        ("--num-processes", args.num_processes is not None),
        ("--process-id", args.process_id is not None),
        ("--img-bf16", args.img_bf16),
    ) if given]
    if args.config in NOT_PORTED_CONFIGS:
        refused.append(f"--config {args.config} "
                       f"({NOT_PORTED_CONFIGS[args.config]}; use r50 or "
                       "r50-fast)")
    return refused


def build_config(args):
    """The model configuration of `--config`, as JAX's CLI builds it,
    trunk bf16 and head fp32 (`--bf16`)."""
    from ..configs.base import (
        simpb_r50_704x256, simpb_r50_704x256_fast, simpb_tiny,
    )

    cfg = {"r50": simpb_r50_704x256, "r50-fast": simpb_r50_704x256_fast,
           "tiny": simpb_tiny}[args.config]()
    return dataclasses.replace(cfg, compute_dtype="bfloat16",
                               head_dtype="float32")


def train_aug_conf(cfg, src_h: int, src_w: int):
    """The training augmentation of the CLI: resize 0.40-0.47, bottom
    crop, random flip, global rotation of +-22.5 degrees; no image
    rotation."""
    fw, fh = cfg.input_size
    return {
        "resize_lim": (0.40, 0.47),
        "final_dim": (fh, fw),
        "bot_pct_lim": (0.0, 0.0),
        "rot_lim": (0, 0),
        "H": src_h,
        "W": src_w,
        "rand_flip": True,
        "rot3d_range": [-0.3925, 0.3925],
    }


def make_batch(dataset, items, rng, prev_pose, cfg):
    """One training batch, numpy on the host, from the sampler's items
    [(frame idx, aug, new_seq)]: each sample through `get_sample` (the
    photometric jitter drawn from `rng`) and `pad_sample`, stacked, with
    `time_interval` and `temp2cur` from `prev_pose`, the per-slot
    (timestamp, lidar2global) of the previous frame, which it updates
    in place. A new sequence (or an empty slot) gets dt = 1e6, which
    breaks the stream (|dt| > max_time_interval)."""
    from ..data.dataset import pad_sample

    raws = [dataset.get_sample(idx, aug=aug, rng=rng)
            for idx, aug, _ in items]
    samples = [
        pad_sample(s, max_gt3d=min(128, cfg.head.num_anchor),
                   max_gt2d=min(64, cfg.head.allocation_capacity))
        for s in raws
    ]
    dts = np.zeros((len(raws),), np.float32)
    t2c = np.tile(np.eye(4, dtype=np.float32), (len(raws), 1, 1))
    for j, (raw, (_, _, new_seq)) in enumerate(zip(raws, items)):
        if new_seq or prev_pose[j] is None:
            dts[j] = 1e6
        else:
            pts, pose = prev_pose[j]
            dts[j] = raw["timestamp"] - pts
            t2c[j] = np.linalg.inv(raw["lidar2global"]) @ pose
        prev_pose[j] = (raw["timestamp"], raw["lidar2global"])
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]
             if k != "gt_depth"}
    batch["time_interval"] = dts
    batch["temp2cur"] = t2c
    if "gt_depth" in samples[0]:
        batch["gt_depth"] = [
            np.stack([s["gt_depth"][lvl] for s in samples])
            for lvl in range(len(samples[0]["gt_depth"]))
        ]
    return batch


def serving_model(cfg, train_model, model=None):
    """A serving `SimPB(cfg)` (built when `model` is None) holding the
    training model's parameters and BatchNorm statistics, in eval mode on
    the same device. Its trunk is the fused inference trunk, which
    computes the module trunk's inference function (BN folded from the
    running statistics)."""
    from ..models.detector import SimPB

    if model is None:
        dev = next(train_model.parameters()).device
        model = SimPB(cfg).to(dev).eval()
    live = train_model.state_dict()
    model.load_state_dict({k: live[k] for k in model.state_dict()},
                          strict=True)
    return model


def run(args, dataset=None, eval_dataset=None):
    """Train as the parsed command line says; returns a dict of what was
    measured and the final state (see the module docstring)."""
    refused = refused_flags(args)
    if refused:
        raise SystemExit(f"not ported: {', '.join(refused)} (ROADMAP.md)")
    import torch

    from ..configs.base import TrainConfig
    from ..data import transforms as T
    from ..data.dataset import NuScenesDataset
    from ..data.sampler import GroupStreamSampler
    from ..training.checkpoint import (
        gather_stream_state, restore_checkpoint, save_checkpoint,
    )
    from ..training.train_step import (
        build_train_model, build_train_step, create_train_state,
        init_temporal,
    )
    from ..utils.benchmark import device_peak_memory
    from ..utils.device import resolve_device
    from ..utils.synthetic import batch_to_torch
    from ..utils.watchdog import PreemptionWatchdog

    cfg = build_config(args)
    device = resolve_device(args.device)
    tc = TrainConfig(batch_size=args.batch_size)
    if args.max_iters:
        tc = dataclasses.replace(tc, num_iters_per_epoch=args.max_iters,
                                 num_epochs=1)
    aug_conf = train_aug_conf(cfg, args.src_h, args.src_w)
    if dataset is None:
        dataset = NuScenesDataset(
            args.ann_file, data_root=args.data_root, test_mode=False,
            data_aug_conf=aug_conf, sequences_split_num=2,
            strides=cfg.strides[: cfg.num_depth_layers],
            draft_decode=args.draft_decode,
        )
    bs = args.batch_size
    sampler = GroupStreamSampler(dataset, batch_size=bs, seed=args.seed)

    model = build_train_model(cfg, device=device, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    if args.anchors:
        anchors = np.load(args.anchors).astype(np.float32)
        with torch.no_grad():
            model.head.anchor.copy_(torch.from_numpy(
                anchors[: cfg.head.num_anchor]))
    if args.pretrained_backbone:
        from ..utils.torch_convert import load_pretrained_backbone

        model.load_state_dict(load_pretrained_backbone(
            args.pretrained_backbone, cfg, model), strict=True)
    if args.load_from:
        from ..utils.torch_convert import load_torch_checkpoint

        model.load_state_dict(load_torch_checkpoint(
            args.load_from, cfg, model), strict=True)

    state = create_train_state(model, tc)
    temporal, dn_state = init_temporal(cfg, bs, device)
    start_iter, resumed_prev_pose, best_score = 0, None, None
    out = dict(losses={}, step_ms=[], queue_wait_ms=[], producer_ms=[],
               checkpoints=[], evals=[], restore_ms=None)
    if args.resume_from:
        # full-state resume: optimizer moments, the temporal instance
        # bank, the DN cache, the host's pose slots and the best score
        t0 = time.perf_counter()
        (state, temporal, dn_state, resumed_prev_pose, start_iter,
         best_score) = restore_checkpoint(args.resume_from, state,
                                          temporal, dn_state)
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        print(f"resumed from {args.resume_from} at iter {start_iter}",
              flush=True)
    step_fn = build_train_step(model, tc)
    os.makedirs(args.work_dir, exist_ok=True)

    # scalars to tensorboard when its package imports (reference
    # TensorboardLoggerHook, config:15-21); skipped otherwise
    tb_writer = None
    if not os.environ.get("SIMPB_NO_TB"):
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(os.path.join(args.work_dir, "tb"))
        except Exception:
            pass

    serve = None

    def run_eval(step_no):
        """Mid-training eval (reference CustomDistEvalHook) in process, on
        a serving model holding the live parameters and statistics."""
        nonlocal eval_dataset, serve
        from ..training.evaluate import streaming_eval

        if eval_dataset is None:
            eval_dataset = NuScenesDataset(
                args.eval_ann_file, data_root=args.data_root,
                test_mode=True,
                data_aug_conf=dict(aug_conf, rand_flip=False,
                                   rot3d_range=[0, 0]),
                sequences_split_num=1, draft_decode=args.draft_decode,
            )
        t0 = time.perf_counter()
        serve = serving_model(cfg, model, serve)
        metrics, preds, _ = streaming_eval(serve, cfg, eval_dataset,
                                           max_frames=args.eval_frames)
        out["evals"].append(dict(
            iter=step_no, metrics=metrics, frames=len(preds),
            ms=(time.perf_counter() - t0) * 1e3))
        print(f"eval @ iter {step_no}: {metrics}", flush=True)
        if tb_writer is not None:
            for k, v in metrics.items():
                if v == v:  # skip NaN (class absent from split)
                    tb_writer.add_scalar(f"val/{k}", float(v), step_no)
            tb_writer.flush()
        return metrics

    # per-slot previous-frame pose and timestamp for the temporal
    # metadata (the host provides dt and temp2cur)
    prev_pose = (resumed_prev_pose
                 if resumed_prev_pose and len(resumed_prev_pose) == bs
                 else [None] * bs)
    max_iters = args.max_iters or tc.max_iters
    it = iter(sampler)
    prefetch: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                prefetch.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def producer():
        try:
            # replay the consumed iterations' draws (sampler and
            # photometric) without loading a frame, so that a resumed
            # run sees the frames and jitter an uninterrupted one would
            for _ in range(start_iter):
                for idx, _, _ in next(it):
                    T.skip_photometric(
                        rng, len(dataset.data_infos[idx]["cams"]))
            for _ in range(start_iter, max_iters):
                t0 = time.perf_counter()
                batch = make_batch(dataset, next(it), rng, prev_pose, cfg)
                out["producer_ms"].append((time.perf_counter() - t0) * 1e3)
                # snapshot the poses AS OF this batch: the producer runs
                # ahead of training, so the live list belongs to later
                # batches and would corrupt a resumed run's first dt
                put((batch, list(prev_pose)))
            put(None)
        except Exception as e:  # surfaces in the training loop
            put(e)

    # preemption-safe save: SIGTERM / SIGUSR1 ask for a full-resume
    # checkpoint at the next step boundary
    preempted = []
    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        try:
            old_handlers[sig] = signal.signal(
                sig, lambda *_: preempted.append(True))
        except (ValueError, OSError):
            pass  # not the main thread
    # the handler above cannot run while the main thread is blocked in
    # a native call; the watchdog then forces a resumable exit (75)
    watchdog = PreemptionWatchdog(deadline_s=args.watchdog_deadline,
                                  work_dir=args.work_dir).arm()

    # fault injection for the watchdog tests: at iter N, block the main
    # thread in an EINTR-restarting native sleep ("ITER:SECONDS")
    hang_iter, hang_secs = -1, 0.0
    if os.environ.get("SIMPB_TEST_NATIVE_HANG"):
        it_s, secs = os.environ["SIMPB_TEST_NATIVE_HANG"].split(":")
        hang_iter, hang_secs = int(float(it_s)), float(secs)

    def save_ckpt(path, trained_pose):
        t0 = time.perf_counter()
        t_host, d_host, pose_host = gather_stream_state(
            temporal, dn_state, trained_pose)
        size = save_checkpoint(path, state, t_host, d_host, pose_host,
                               best_score=best_score)
        out["checkpoints"].append(dict(
            path=path, bytes=size, ms=(time.perf_counter() - t0) * 1e3))
        watchdog.record_checkpoint(path)
        print(f"saved {path}", flush=True)

    worker = threading.Thread(target=producer, daemon=True)
    worker.start()
    trained_pose = list(prev_pose)
    try:
        t0 = t_log = time.perf_counter()
        for i in range(start_iter, max_iters):
            item = prefetch.get()
            t_got = time.perf_counter()
            out["queue_wait_ms"].append((t_got - t0) * 1e3)
            if item is None:
                break
            if isinstance(item, Exception):
                raise RuntimeError("the data producer failed") from item
            batch, trained_pose = item
            batch = batch_to_torch(batch, device)
            if (i + 1) == hang_iter:
                from ..data.native_preprocess import native_hang

                print(f"[fault-injection] native hang {hang_secs}s @ iter "
                      f"{i + 1}", flush=True)
                native_hang(hang_secs)
            state, temporal, dn_state, metrics = step_fn(
                state, batch, temporal, dn_state, args.seed)
            watchdog.heartbeat(step=i + 1)
            if (i + 1) % args.log_interval == 0:
                losses = {k: float(v) for k, v in metrics.items()}
                out["losses"][i + 1] = losses
                dt = time.perf_counter() - t_log
                print(f"iter {i + 1}/{max_iters} loss {losses['loss']:.4f} "
                      f"({dt / args.log_interval:.2f}s/iter)", flush=True)
                if i + 1 == start_iter + args.log_interval:
                    peak = device_peak_memory(device)
                    if peak is not None:
                        print(f"peak device memory in use: "
                              f"{peak / 2**30:.2f} GiB", flush=True)
                if tb_writer is not None:
                    for k, v in losses.items():
                        tb_writer.add_scalar(k, v, i + 1)
                    tb_writer.flush()
                t_log = time.perf_counter()
            # with a log line every step, float(loss) synchronises and
            # this is the step's time on the host clock
            out["step_ms"].append((time.perf_counter() - t_got) * 1e3)

            if preempted:
                # graceful preemption path engaged: the watchdog stands
                # down; the checkpoint below owns the shutdown
                watchdog.acknowledge()
                save_ckpt(os.path.abspath(os.path.join(
                    args.work_dir, f"ckpt_preempt_{i + 1}")), trained_pose)
                print(f"preemption signal: checkpointed at iter {i + 1}, "
                      "exiting (resume with --resume-from)", flush=True)
                break
            if (i + 1) % args.ckpt_interval == 0 or i + 1 == max_iters:
                save_ckpt(os.path.abspath(os.path.join(
                    args.work_dir, f"ckpt_{i + 1}")), trained_pose)
            if args.eval_ann_file and (i + 1) % args.eval_interval == 0:
                # best checkpoint on the key score (reference
                # CustomDistEvalHook save_best; NDS for nuScenes)
                score = run_eval(i + 1).get("NDS", float("nan"))
                if score == score and (best_score is None
                                       or score > best_score):
                    best_score = score
                    print(f"new best NDS {score:.4f} @ iter {i + 1}",
                          flush=True)
                    save_ckpt(os.path.abspath(os.path.join(
                        args.work_dir, "ckpt_best")), trained_pose)
            t0 = time.perf_counter()
    finally:
        stop.set()
        worker.join(timeout=60)
        watchdog.disarm()
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        if tb_writer is not None:
            tb_writer.close()
    out.update(state=state, temporal=temporal, dn_state=dn_state,
               prev_pose=trained_pose, best_score=best_score,
               start_iter=start_iter, route_counts=dict(dataset.route_counts)
               if hasattr(dataset, "route_counts") else None)
    return out


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
