"""The training step: AdamW with per-group clipping + warmup-cosine
schedule (port of `simpb_tpu/training/train_step.py`).

`create_train_state(model, tc)` wraps a `SimPB(cfg, train=True)` whose
parameters and BatchNorm running statistics are the state;
`build_train_step(model, tc)` returns

    step(state, batch, temporal, dn_state, seed) ->
        (state, temporal, dn_state, metrics)

which folds the step number into the seed and splits it four ways,
`r_dn, r_aug, r_drop, r_samp` (DN noise, grid mask, dropout, the head's
sampling draws), builds the DN bundle, runs the model forward and
backward on `total_loss` and applies the optimizer in place. The batch
is the JAX step's dict of tensors (`utils/synthetic.py::
synthetic_train_batch` makes one).

Data parallel (under a process group, `parallel/mesh.py`): each rank
takes its rows of the global batch with the same seed, so its four
generators are every other rank's; the draws whose axis is the batch
keep this rank's rows of the global draw. Each rank's loss is its local
sum over the global normalisers (`loss_head.py`), the BatchNorm
statistics are the global batch's, and after the backward every
gradient is summed over the ranks (one flat buffer, the parameters'
order) before the optimizer, whose per-group clip then sees the global
gradient, as optax's does under `pjit`. So N ranks at bs b take the
step one process takes at bs N * b, and the parameters, statistics and
moments stay equal on every rank. The reduction is explicit rather than
`DistributedDataParallel`'s: the BatchNorm collectives run inside the
backward under remat, some parameters take no gradient, and a fixed
order keeps repeats deterministic.

The optimizer is optax's `multi_transform` of the JAX package, written
out: each label's chain is `clip_by_global_norm(grad_clip_norm)` (over
that label's parameters only: "default" and "backbone" are clipped to
their own norms), Adam (b1 0.9, b2 0.999, eps 1e-8), decoupled weight
decay, then the scheduled step size (times `backbone_lr_mult` for the
backbone); "frozen" parameters (the fixed-zero instance feature) never
move.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig, TrainConfig
from ..models.instance_bank import TemporalState
from ..parallel.mesh import all_reduce_sum_
from .dn import DnState
from .loss_head import total_loss
from .targets3d import TargetConfig, get_dn_anchors

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def lr_schedule(tc: TrainConfig):
    """Linear warmup from lr * warmup_ratio over warmup_iters, then
    cosine annealing to lr * min_lr_ratio (optax's join of a linear and
    a cosine-decay schedule, in its float32 arithmetic): step ->
    learning rate."""
    f32 = np.float32
    decay_steps = f32(max(tc.max_iters - tc.warmup_iters, 1))
    init, peak, alpha = f32(tc.lr * tc.warmup_ratio), f32(tc.lr), \
        f32(tc.min_lr_ratio)

    def sched(step: int) -> float:
        if step < tc.warmup_iters:
            count = min(max(step, 0), tc.warmup_iters)
            frac = f32(1) - f32(count) / f32(tc.warmup_iters)
            return float((init - peak) * frac + peak)
        count = np.minimum(f32(step - tc.warmup_iters), decay_steps)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * count
                                             / decay_steps))
        return float(peak * ((f32(1) - alpha) * cosine + alpha))

    return sched


def _param_labels(named_params) -> Dict[str, str]:
    """name -> "backbone" (the trunk, lr multiplier), "frozen" (the
    fixed-zero instance feature) or "default"."""
    labels = {}
    for name, _ in named_params:
        parts = name.split(".")
        if "img_backbone" in parts:
            labels[name] = "backbone"
        elif parts[-1] == "instance_feature":
            labels[name] = "frozen"
        else:
            labels[name] = "default"
    return labels


@dataclasses.dataclass
class TrainState:
    """The model holds the parameters and the BatchNorm statistics;
    `opt_state` maps a parameter's name to its Adam moments (mu, nu)."""

    step: int
    model: Any
    opt_state: Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def create_train_state(model, tc: TrainConfig) -> TrainState:
    opt_state = {
        name: (torch.zeros_like(p, dtype=torch.float32),
               torch.zeros_like(p, dtype=torch.float32))
        for name, p in model.named_parameters()
    }
    return TrainState(step=0, model=model, opt_state=opt_state)


@torch.no_grad()
def apply_optimizer(state: TrainState, tc: TrainConfig,
                    grads: Dict[str, torch.Tensor]) -> None:
    """One update of every parameter in place (optax's multi_transform:
    per label clip -> Adam -> weight decay -> -lr * mult); missing
    gradients count as zero; advances `state.step`."""
    params = dict(state.model.named_parameters())
    labels = _param_labels(params.items())
    lr = lr_schedule(tc)(state.step)
    count = state.step + 1
    bc1 = 1 - ADAM_B1 ** count
    bc2 = 1 - ADAM_B2 ** count
    for group, mult in (("default", 1.0),
                        ("backbone", tc.backbone_lr_mult)):
        names = [n for n in params if labels[n] == group]
        g = {n: (grads.get(n) if grads.get(n) is not None
                 else torch.zeros_like(params[n])).float() for n in names}
        if not names:
            continue
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        clip = not bool(norm < tc.grad_clip_norm)
        for n in names:
            gi = g[n] / norm * tc.grad_clip_norm if clip else g[n]
            mu, nu = state.opt_state[n]
            mu.copy_((1 - ADAM_B1) * gi + ADAM_B1 * mu)
            nu.copy_((1 - ADAM_B2) * (gi * gi) + ADAM_B2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            upd = upd + tc.weight_decay * params[n].float()
            params[n].copy_(params[n] + upd * (-(lr * mult)))
    state.step += 1


def step_generators(seed: int, step: int, device) -> Tuple[torch.Generator,
                                                           ...]:
    """The step's four generators (r_dn, r_aug, r_drop, r_samp), from
    the seed with the step number folded in. r_aug is a CPU generator
    (the grid mask draws four host scalars); the others live on
    `device`."""
    base = torch.Generator().manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    seeds = torch.randint(0, 2 ** 62, (4,), generator=base).tolist()
    dev = torch.device(device)
    gens = []
    for i, s in enumerate(seeds):
        gen = torch.Generator(device="cpu" if i == 1 else dev)
        gens.append(gen.manual_seed(s))
    return tuple(gens)


def build_train_step(model, tc: TrainConfig,
                     target_cfg: TargetConfig = TargetConfig()):
    """Returns step(state, batch, temporal, dn_state, seed) ->
    (state, temporal, dn_state, metrics); `metrics` holds "loss" and the
    loss dict, detached."""
    cfg: ModelConfig = model.cfg
    h = cfg.head

    def loss_fn(batch, temporal, dn_state, gens):
        r_dn, r_aug, r_drop, r_samp = gens
        dn = get_dn_anchors(
            r_dn, batch["gt_boxes3d"], batch["gt_labels3d"],
            batch["gt_valid3d"], gt_instance_id=batch.get("gt_instance_id"),
            gt_vis2d=batch.get("gt_vis2d_per3d"),
            gt_boxes2d=batch.get("gt_boxes2d_per3d"),
            gt_labels2d=batch.get("gt_labels2d_per3d"),
            gt_alphas2d=batch.get("gt_alphas2d_per3d"),
            num_dn_groups=h.num_dn_groups, max_dn_gt=h.max_dn_gt,
            add_neg_dn=h.add_neg_dn, noise_scale=h.dn_noise_scale,
            num_cams=h.num_cams, cfg=target_cfg,
        )
        outs = model(
            batch["img"], batch["projection_mat"], temporal=temporal,
            time_interval=batch.get("time_interval"),
            temp2cur=batch.get("temp2cur"), focal=batch.get("focal"),
            dn=dn, dn_state=dn_state, train=True,
            rngs={"aug": r_aug, "dropout": r_drop, "sampling": r_samp},
        )
        loss, loss_dict = total_loss(
            outs, batch, tc, target_cfg, image_wh=cfg.input_size,
            num_single_frame_decoder=h.num_single_frame_decoder)
        return loss, loss_dict, outs

    def train_step(state: TrainState, batch: Dict[str, Any],
                   temporal: Optional[TemporalState],
                   dn_state: Optional[DnState], seed: int, marks=None):
        """One step. `marks`, a list, gets (name, CUDA event) pairs
        recorded at "start" and after the "forward", "backward" (the
        gradients summed over the ranks) and "optimizer" parts (on the
        card only). The metrics are the global batch's."""

        def mark(name):
            if marks is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name, ev))

        model.train()
        dev = batch["img"].device
        gens = step_generators(seed, state.step, dev)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        mark("start")
        loss, loss_dict, outs = loss_fn(batch, temporal, dn_state, gens)
        mark("forward")
        loss.backward()
        # every rank reduces the same list: a parameter without a
        # gradient contributes zeros
        grads = {n: (p.grad if p.grad is not None
                     else torch.zeros_like(p)) for n, p in params.items()}
        all_reduce_sum_(list(grads.values()))
        mark("backward")
        apply_optimizer(state, tc, grads)
        mark("optimizer")
        metrics = {k: torch.as_tensor(v).detach().float().clone()
                   for k, v in {"loss": loss, **loss_dict}.items()}
        all_reduce_sum_(list(metrics.values()))
        return (state, outs["temporal_state"], outs.get("dn_state"),
                metrics)

    return train_step


def build_train_model(cfg: ModelConfig, device=None, seed: int = 0):
    """A `SimPB(cfg, train=True)` with seeded random weights and the
    synthetic anchors on `device` (the card unless the caller names
    another; raises without a card)."""
    from ..models.detector import SimPB
    from ..utils.device import resolve_device
    from ..utils.synthetic import randomize_

    dev = resolve_device(device)
    model = SimPB(cfg, train=True)
    randomize_(model, seed)
    return model.to(dev)


def init_temporal(cfg: ModelConfig, bs: int, device=None
                  ) -> Tuple[TemporalState, DnState]:
    """The empty `TemporalState` and `DnState` of a batch of `bs`, on
    `device` (the card unless the caller names another; raises without
    a card)."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    h = cfg.head
    num_per = h.max_dn_gt * (2 if h.add_neg_dn else 1)
    return (
        TemporalState.init(bs, h.num_temp_instances, h.num_anchor,
                           h.embed_dims, device=device),
        DnState.init(bs, h.num_temp_dn_groups, num_per, h.embed_dims,
                     h.num_cams, device=device),
    )
