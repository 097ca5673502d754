"""Serving export: the streaming step as one `torch.export` program
(port of `simpb_tpu/utils/export.py`).

The JAX artifact is a weights-baked `jax.export` program. The port's is
the `torch.export.export` of `make_serving_fn` (the streaming step, then
`decode_boxes3d`), serialized with `torch.export.save`: the parameters
and BatchNorm statistics travel in the program's state, and the fused
trunk's folded weights are built inside the graph from them
(`models/backbone.py::_FoldCache`). Every kernel of the step is a
`simpb::` custom op in the graph (`ops/conv_fused.py`,
`ops/sampling.py`), so the program launches the hand-written kernels on
the card, and their plain versions on the CPU, exactly as the model
does.

"Runnable without model code" reads here: loading and running an
artifact (`ServingModel`) needs `simpb_tpu_torch.ops`, whose import
registers the ops, and nothing of `simpb_tpu_torch.models`. The program
runs on the device it was exported on.

The boundary uses standard containers only, as in JAX: the temporal
state is a 5-tuple (`TEMPORAL_FIELDS`).

Artifact signature:
  (img [bs, cams, H, W, 3] f32, projection_mat [bs, cams, 4, 4] f32,
   time_interval [bs] f32, temp2cur [bs, 4, 4] f32, temporal 5-tuple)
  -> {"boxes": [bs, K, 10], "scores": [bs, K], "labels": [bs, K],
      "cls_scores": [bs, K], "valid": [bs, K], "instance_ids": [bs, K],
      "temporal": 5-tuple}
"""
from __future__ import annotations

import dataclasses
import io
from typing import Tuple

import torch

from .. import ops  # noqa: F401  (registers the simpb:: ops a program calls)
from ..configs.base import ModelConfig
from ..core.box3d import STATE_DIM

TEMPORAL_FIELDS = (
    "feature", "anchor", "confidence", "instance_id", "prev_id"
)


def temporal_to_tuple(state) -> Tuple[torch.Tensor, ...]:
    return tuple(getattr(state, f) for f in TEMPORAL_FIELDS)


def tuple_to_temporal(leaves):
    from ..models.instance_bank import TemporalState

    return TemporalState(**dict(zip(TEMPORAL_FIELDS, leaves)))


def init_temporal(batch_size: int, num_temp: int, num_anchor: int,
                  embed: int, device=None) -> Tuple[torch.Tensor, ...]:
    """An empty stream's state as the 5-tuple (`TemporalState.init`'s
    values, built without the model code)."""
    z = lambda *shape: torch.zeros(shape, device=device)
    return (z(batch_size, num_temp, embed), z(batch_size, num_temp,
                                              STATE_DIM),
            z(batch_size, num_temp),
            torch.full((batch_size, num_anchor), -1, dtype=torch.int32,
                       device=device),
            torch.zeros((batch_size,), dtype=torch.int32, device=device))


class ServingStep(torch.nn.Module):
    """The streaming step over `model`'s weights plus the fixed-shape
    decode; the module `export_serving` exports."""

    def __init__(self, cfg: ModelConfig, model: torch.nn.Module):
        super().__init__()
        self.cfg = cfg
        self.model = model

    def forward(self, img, projection_mat, time_interval, temp2cur,
                temporal):
        from ..models.decoder3d import decode_boxes3d

        hc = self.cfg.head
        out = self.model(img, projection_mat,
                         temporal=tuple_to_temporal(temporal),
                         time_interval=time_interval, temp2cur=temp2cur)
        new_state = out["temporal_state"]
        det = decode_boxes3d(
            out["classification"][-1], out["prediction"][-1],
            instance_id=new_state.instance_id, quality=out["quality"][-1],
            num_output=hc.num_output, score_threshold=hc.score_threshold,
        )
        return {
            "boxes": det["boxes_3d"],
            "scores": det["scores_3d"],
            "labels": det["labels_3d"].to(torch.int32),  # JAX's type
            "cls_scores": det["cls_scores"],
            "valid": det["valid"],
            "instance_ids": det["instance_ids"],
            "temporal": temporal_to_tuple(new_state),
        }


def make_serving_fn(cfg: ModelConfig, model: torch.nn.Module) -> ServingStep:
    """The streaming step + decode over `model` (which holds the
    weights; JAX's closes over its variables)."""
    return ServingStep(cfg, model.eval())


def example_inputs(cfg: ModelConfig, batch_size: int = 1, device=None):
    """Tensors of the artifact's input signature (zeros; an empty
    stream's state)."""
    hc = cfg.head
    w, h = cfg.input_size
    cams = hc.num_cams
    z = lambda *shape: torch.zeros(shape, device=device)
    return (
        z(batch_size, cams, h, w, 3),
        z(batch_size, cams, 4, 4),
        z(batch_size),
        z(batch_size, 4, 4),
        init_temporal(batch_size, hc.num_temp_instances, hc.num_anchor,
                      hc.embed_dims, device),
    )


def export_serving(cfg: ModelConfig, model: torch.nn.Module,
                   batch_size: int = 1) -> bytes:
    """The serialized program of the streaming step (weights in its
    state), for inputs on `model`'s device."""
    device = next(model.parameters()).device
    with torch.no_grad():  # the step's own no_grad then records nothing
        program = torch.export.export(
            make_serving_fn(cfg, model),
            example_inputs(cfg, batch_size, device))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


@dataclasses.dataclass
class ServingModel:
    """Host-side wrapper over a loaded artifact."""

    program: "torch.export.ExportedProgram"

    def __post_init__(self):
        self._step = self.program.module()

    @classmethod
    def load(cls, data: bytes) -> "ServingModel":
        return cls(torch.export.load(io.BytesIO(data)))

    @property
    def device(self) -> torch.device:
        for t in self.program.state_dict.values():
            return t.device
        return torch.device("cpu")

    def init_temporal(self, batch_size, num_temp, num_anchor, embed):
        return init_temporal(batch_size, num_temp, num_anchor, embed,
                             self.device)

    def __call__(self, img, projection_mat, time_interval, temp2cur,
                 temporal):
        return self._step(img, projection_mat, time_interval, temp2cur,
                          tuple(temporal))
