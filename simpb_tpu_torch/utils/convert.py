"""JAX variable tree -> the port's state dict.

`from_jax_variables` takes the JAX package's `{"params", "batch_stats"}`
tree as nested dicts of numpy arrays (what
`jax.tree_util.tree_map(np.asarray, variables)` gives) and returns a
state dict that `SimPB(cfg).load_state_dict(..., strict=True)` takes.
The port's modules carry the JAX tree's names, so each module's path is
its JAX path; only layouts change:

    Dense kernel [in, out]           -> Linear weight [out, in]
    Conv kernel [kh, kw, in, out]    -> Conv2d weight [out, in, kh, kw]
    LayerNorm / BatchNorm scale      -> weight
    BatchNorm batch_stats mean / var -> running_mean / running_var

JAX leaves with no counterpart are refused, except the two kinds the
serving model does not hold: the training-only depth branch, and the
cls / quality branches of intermediate refine3d layers (present in a
tree initialised for training, unused at inference).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_TRAIN_ONLY = re.compile(
    r"^params/(depth_branch/|head/op\d+_refine3d/(cls_|quality_))"
)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _sources(mod: nn.Module, prefix: str):
    """(torch name, JAX path, layout fn) of one module's own tensors."""
    parts = prefix.split(".") if prefix else []
    dot = prefix + "." if prefix else ""
    path = lambda kind, leaf: "/".join([kind, *parts, leaf])
    ident = lambda a: a
    if isinstance(mod, nn.Linear):
        yield dot + "weight", path("params", "kernel"), lambda a: a.T
        if mod.bias is not None:
            yield dot + "bias", path("params", "bias"), ident
    elif isinstance(mod, nn.Conv2d):
        yield (dot + "weight", path("params", "kernel"),
               lambda a: a.transpose(3, 2, 0, 1))
        if mod.bias is not None:
            yield dot + "bias", path("params", "bias"), ident
    elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
        yield dot + "weight", path("params", "scale"), ident
        yield dot + "bias", path("params", "bias"), ident
        if isinstance(mod, nn.BatchNorm2d):
            yield dot + "running_mean", path("batch_stats", "mean"), ident
            yield dot + "running_var", path("batch_stats", "var"), ident
    else:
        for name, _ in mod.named_parameters(recurse=False):
            yield dot + name, path("params", name), ident


def state_from_jax(model: nn.Module, variables: Mapping,
                   unused_ok=_TRAIN_ONLY) -> Dict[str, torch.Tensor]:
    """The state dict of `model` (any module of the port) holding the
    values of the JAX tree `variables` of its counterpart. JAX leaves
    without a counterpart raise unless `unused_ok` matches their path."""
    leaves = _flatten(variables)
    used = set()
    state: Dict[str, torch.Tensor] = {}
    expected: Dict[str, Tuple[int, ...]] = {
        k: tuple(v.shape) for k, v in model.state_dict().items()
    }
    for prefix, mod in model.named_modules():
        for tname, jpath, layout in _sources(mod, prefix):
            if jpath not in leaves:
                raise KeyError(f"{tname}: JAX leaf {jpath} is missing")
            arr = np.ascontiguousarray(layout(leaves[jpath]), np.float32)
            if tuple(arr.shape) != expected[tname]:
                raise ValueError(f"{tname}: shape {arr.shape} from {jpath}, "
                                 f"expected {expected[tname]}")
            state[tname] = torch.from_numpy(arr.copy())
            used.add(jpath)
        if isinstance(mod, nn.BatchNorm2d):
            key = f"{prefix}.num_batches_tracked" if prefix else \
                "num_batches_tracked"
            state[key] = torch.tensor(0)
    unknown = sorted(
        p for p in leaves
        if p not in used and not (unused_ok and unused_ok.match(p))
    )
    if unknown:
        raise KeyError(f"JAX leaves with no counterpart: {unknown[:8]}")
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"state dict entries not filled: {missing[:8]}")
    return state


def from_jax_variables(variables: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The state dict of `SimPB(cfg)` holding the JAX tree's values."""
    from ..models.detector import SimPB

    with torch.device("meta"):
        model = SimPB(cfg)
    return state_from_jax(model, variables)
