"""The serving entry: cold and stream steps of the temporal stream
(port of `simpb_tpu/training/evaluate.py::_jitted_steps`; the dataset
loop `streaming_eval` and its scoring come later).

    cold_step, stream_step = make_stream_steps(model, cfg)
    decoded, state = cold_step(img, proj)
    decoded, state = stream_step(img, proj, state, dt, temp2cur)
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.decoder3d import decode_boxes3d
from ..models.instance_bank import TemporalState

Step = Callable[..., Tuple[Dict[str, torch.Tensor], TemporalState]]


def make_stream_steps(model, cfg: ModelConfig) -> Tuple[Step, Step]:
    """(cold_step, stream_step), each returning (decoded, temporal_state).

    cold_step(img, proj) starts a stream; stream_step(img, proj, state,
    time_interval, temp2cur) carries the instance bank. Both run on the
    model's device, in inference mode."""

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
