"""Streaming-throughput measurement core (port of
`simpb_tpu/utils/benchmark.py`).

The method is the JAX package's, in PyTorch terms: seeded random weights
and the synthetic anchors (`training/evaluate.py::build_model`) and rig;
the stream starts from an empty `TemporalState` and every frame is a
stream step. Each frame's images are generated on the device from a
seeded `torch.Generator` inside the timed window and charged against
the number, as the JAX scan body generates them; the stream step and
the decode run every frame, and the decode is reduced to a probe on the
device so that nothing is skipped. One warm window runs, then one timed
window, which ends in a `torch.cuda.synchronize()` (host clock around
it). Under `guard_sampling` the guard counters join the probe, so that
their cost is charged too. The reference benchmark reports fps and peak CUDA memory
(reference tools/benchmark.py:100-113); so does this one.
"""
from __future__ import annotations

import time

import torch


def device_peak_memory(device=None):
    """Peak device bytes allocated since the last reset
    (`torch.cuda.max_memory_allocated`), or None off a CUDA device."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.max_memory_allocated(device))


def run_benchmark(
    cfg, window: int = 128, batch_size: int = 1,
    return_stats: bool = False, device=None,
):
    """Six-camera frames/sec for `cfg` on `device` (the card unless the
    caller names another): `window * batch_size` frames over the timed
    window's seconds. With `return_stats=True`, `(fps, stats)` where
    stats carries `peak_hbm_bytes`, the peak of
    `torch.cuda.max_memory_allocated` over both windows (None off the
    card)."""
    from ..models.instance_bank import TemporalState
    from ..training.evaluate import build_model, make_stream_steps
    from .synthetic import synthetic_rig

    model = build_model(cfg, device=device, seed=0)
    dev = next(model.parameters()).device
    bs, cams = batch_size, cfg.head.num_cams
    w, h = cfg.input_size
    proj = torch.from_numpy(synthetic_rig(bs, image_wh=(w, h))).to(dev)
    dt = torch.full((bs,), 0.5, device=dev)
    t2c = torch.eye(4, device=dev).expand(bs, 4, 4).contiguous()
    _, stream_step = make_stream_steps(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(17)

    def rollout(state):
        probe = torch.zeros((), device=dev)
        for _ in range(window):
            frame = torch.randn((bs, cams, h, w, 3), generator=gen,
                                device=dev)
            dec, state = stream_step(frame, proj, state, dt, t2c)
            probe = probe + dec["scores_3d"].max() + dec["boxes_3d"].sum()
            # under guard_sampling the guard counters, which every eval
            # of such a config computes, are charged against the number
            for k in dec:
                if k.startswith("guard_"):
                    probe = probe + dec[k].sum()
        return state, probe

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = TemporalState.init(
        bs, cfg.head.num_temp_instances, cfg.head.num_anchor,
        cfg.head.embed_dims, device=dev,
    )
    state, probe = rollout(state)  # warm
    probe.item()
    sync()
    t0 = time.perf_counter()
    state, probe = rollout(state)
    sync()
    elapsed = time.perf_counter() - t0
    if not torch.isfinite(probe):
        raise RuntimeError(f"benchmark probe is not finite: {probe.item()}")
    fps = window * bs / elapsed
    if return_stats:
        return fps, {"peak_hbm_bytes": device_peak_memory(dev)}
    return fps
