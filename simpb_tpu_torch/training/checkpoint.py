"""Full-state checkpoints: parameters, optimizer moments, the streaming
temporal state (port of `simpb_tpu/training/checkpoint.py`).

The port's own format, one `torch.save` of one dict (no orbax, which
needs JAX), holding:

* `model`: the training model's `state_dict` (parameters and BatchNorm
  buffers);
* `opt_state`: each parameter's Adam moments (mu, nu), and `step`;
* `temporal` and `dn_state`: every field of the `TemporalState` and the
  `DnState` the stream carries;
* `prev_pose`: the host's per-slot previous timestamp and
  `lidar2global`, packed as arrays;
* `best_score`: the best mid-training NDS so far (NaN = none yet), so
  that a resumed run cannot overwrite `ckpt_best` with a worse score.

So a resumed run continues the exact stream the interrupted one was on
(the reference restarts its temporal stream cold on resume).

Data parallel (`parallel/mesh.py`): `gather_stream_state` all-gathers
every rank's stream slots in rank order (every rank calls it); rank 0
alone writes the file, and every rank waits for it after; a restore
reads the whole file on every rank and keeps the rank's slots
`rank * bs_local:(rank + 1) * bs_local`, which is the sampler's
rank-to-slot mapping. A checkpoint of another world size (its slot count
not `bs_local * world`) raises. Every
value is a tensor, a number or None, so `torch.load(weights_only=True)`
reads it. A restore goes into the caller's templates on their devices,
with `strict=True` for the model and every other entry checked by name,
shape and dtype. The JAX package also restores its older params-only
checkpoints; the port has no older format, so it has no such branch.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import (
    all_gather_rows, host_barrier, process_count, process_index,
)

FORMAT = "simpb_tpu_torch.checkpoint/1"


def _pack_prev_pose(prev_pose: Optional[List]) -> Dict[str, torch.Tensor]:
    """[(timestamp, lidar2global 4x4) | None] per slot -> dense tensors
    (float64, as the host keeps them)."""
    n = len(prev_pose) if prev_pose else 0
    ts = np.zeros((n,), np.float64)
    pose = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    has = np.zeros((n,), bool)
    for i, p in enumerate(prev_pose or []):
        if p is not None:
            ts[i], pose[i] = p[0], p[1]
            has[i] = True
    return {k: torch.from_numpy(v) for k, v in
            (("ts", ts), ("pose", pose), ("has", has))}


def _unpack_prev_pose(packed: Dict[str, torch.Tensor]) -> List:
    out: List = []
    for i in range(len(packed["has"])):
        out.append(
            (float(packed["ts"][i]), packed["pose"][i].numpy().copy())
            if bool(packed["has"][i])
            else None
        )
    return out


def gather_stream_state(temporal, dn_state, prev_pose: Optional[List]):
    """The whole stream's state: every rank's slots of the temporal
    state, the DN state and the host poses, all-gathered in rank order
    (the identity on one process). Every rank must call it. Returns
    (temporal, dn_state, prev_pose) over the global batch."""
    if process_count() == 1:
        return temporal, dn_state, prev_pose

    def gather(obj):
        if obj is None:
            return None
        return dataclasses.replace(obj, **{
            f.name: all_gather_rows(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})

    packed = {k: all_gather_rows(v)
              for k, v in _pack_prev_pose(prev_pose).items()}
    return gather(temporal), gather(dn_state), _unpack_prev_pose(packed)


def _fields(obj) -> Optional[Dict[str, torch.Tensor]]:
    if obj is None:
        return None
    return {f.name: getattr(obj, f.name).detach().cpu()
            for f in dataclasses.fields(obj)}


def _check(name: str, saved: torch.Tensor, like: torch.Tensor) -> None:
    if saved.shape != like.shape or saved.dtype != like.dtype:
        raise ValueError(f"checkpoint entry {name}: {tuple(saved.shape)} "
                         f"{saved.dtype}, expected {tuple(like.shape)} "
                         f"{like.dtype}")


def _rank_slots(kind: str, saved: torch.Tensor, like: torch.Tensor):
    """This rank's slots of a saved stream field (all of them at world
    1); a slot count other than `bs_local * world` raises."""
    world = process_count()
    if world == 1:
        return saved
    n = like.shape[0]
    if saved.shape[0] != n * world:
        raise ValueError(f"checkpoint {kind}: {saved.shape[0]} stream "
                         f"slots, expected {n} a rank x {world} ranks")
    return saved[process_index() * n:(process_index() + 1) * n]


def _restore_fields(kind: str, template, saved):
    """`template` (a dataclass of tensors) with the saved fields (this
    rank's slots), on the template's devices; None where the checkpoint
    holds none."""
    if saved is None:  # the stream carried none
        return None
    if template is None:
        raise ValueError(f"checkpoint {kind}: saved, but no template")
    names = [f.name for f in dataclasses.fields(template)]
    if sorted(saved) != sorted(names):
        raise KeyError(f"checkpoint {kind} fields {sorted(saved)}, "
                       f"expected {sorted(names)}")
    out = {}
    for n in names:
        like = getattr(template, n)
        mine = _rank_slots(f"{kind}.{n}", saved[n], like)
        _check(f"{kind}.{n}", mine, like)
        out[n] = mine.to(like.device)
    return dataclasses.replace(template, **out)


def save_checkpoint(
    path: str,
    state,
    temporal,
    dn_state,
    prev_pose: Optional[List] = None,
    best_score: Optional[float] = None,
) -> int:
    """Write `state` (a `TrainState`), the stream state, the host poses
    and the best score to the file `path` (written to a temporary name,
    then renamed, so a reader never sees half a file). Under a process
    group rank 0 writes (the stream state gathered first, by
    `gather_stream_state`) and every rank returns after the file is
    there. Returns the file's size in bytes (None on the other
    ranks)."""
    path = os.path.abspath(path)
    if process_index() != 0:
        host_barrier(f"checkpoint {path}")
        return None
    tree = {
        "format": FORMAT,
        "model": {k: v.detach().cpu()
                  for k, v in state.model.state_dict().items()},
        "opt_state": {n: (mu.detach().cpu(), nu.detach().cpu())
                      for n, (mu, nu) in state.opt_state.items()},
        "step": int(state.step),
        "temporal": _fields(temporal),
        "dn_state": _fields(dn_state),
        "prev_pose": _pack_prev_pose(prev_pose),
        "best_score": float(best_score if best_score is not None
                            else math.nan),
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    host_barrier(f"checkpoint {path}")
    return os.path.getsize(path)


def load_model_state(path: str) -> Dict[str, torch.Tensor]:
    """The training model's `state_dict` saved in a checkpoint (on the
    CPU), for a serving model to take its part (`tools/test.py
    --checkpoint`)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this package "
                         f"(format {FORMAT})")
    return ckpt["model"]


def restore_checkpoint(
    path: str, state, temporal, dn_state
) -> Tuple[Any, Any, Any, Optional[List], int, Optional[float]]:
    """Restore into the given templates (`state.model` and the moments in
    place; the stream state as new tensors on the templates' devices).

    Returns (state, temporal, dn_state, prev_pose | None, start_iter,
    best_score | None), the stream state and poses this rank's slots.
    A checkpoint of another configuration, batch size, world size or
    format raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this package "
                         f"(format {FORMAT})")
    state.model.load_state_dict(ckpt["model"], strict=True)
    saved = ckpt["opt_state"]
    if sorted(saved) != sorted(state.opt_state):
        raise KeyError("checkpoint optimizer state covers other parameters")
    with torch.no_grad():
        for n, (mu, nu) in state.opt_state.items():
            for kind, dst, src in (("mu", mu, saved[n][0]),
                                   ("nu", nu, saved[n][1])):
                _check(f"opt_state.{n}.{kind}", src, dst)
                dst.copy_(src)
    state.step = int(ckpt["step"])
    temporal = _restore_fields("temporal", temporal, ckpt["temporal"])
    dn_state = _restore_fields("dn_state", dn_state, ckpt["dn_state"])
    prev_pose = None
    if len(ckpt["prev_pose"]["has"]):
        prev_pose = _unpack_prev_pose(ckpt["prev_pose"])
        if process_count() > 1:
            n = len(prev_pose) // process_count()
            prev_pose = prev_pose[process_index() * n:
                                  (process_index() + 1) * n]
    best = float(ckpt["best_score"])
    return (state, temporal, dn_state, prev_pose, state.step,
            None if math.isnan(best) else best)
