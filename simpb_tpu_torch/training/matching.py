"""Exact linear assignment (port of `simpb_tpu/training/matching.py`).

Shortest augmenting path with dual potentials (Jonker-Volgenant), the
scheme scipy's `linear_sum_assignment` uses. The JAX package runs it in
`lax` loops on the device so that target assignment needs no host sync;
the port runs it on the card as kernel A (`csrc/assignment.cu`, one
warp per cost matrix) and never calls scipy on the training step's
path (scipy is the tests' oracle).

`linear_sum_assignment_plain` is the same algorithm, step for step, in
PyTorch on the CPU: rows in order, the Dijkstra loop over columns, the
dual updates, the augmentation. Its argmin takes the lowest index among
equal minima (as `jnp.argmin`) and the reduced cost is summed in the
JAX order, `min_val + cost[i] - u[i] - v`, so that it and the kernel
take JAX's tie decisions. It is slow and serves the tests and the chip
check.

`batched_assignment` is the wrapper: CPU tensors run the plain version,
CUDA tensors launch the kernel (or raise). Costs must be finite with
R <= C; `masked_assignment` pushes padded rows to a constant cost and
replaces NaN and infinities first. The kernel takes the row flags and
the pad cost themselves: a padded row's Dijkstra steps read no cost
row (most of a padded matrix's steps).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops import _kernels

INF = 1e30
MAX_COLS = 1024  # kernel A: 32 columns a lane at most
_LAUNCHES = {"assignment": 0}


def linear_sum_assignment_plain(cost: torch.Tensor,
                                steps: Optional[list] = None
                                ) -> torch.Tensor:
    """cost [R, C] (R <= C, finite) -> col4row [R] int32, the column of
    each row in a minimal-cost assignment. `steps`, if given, gets the
    number of Dijkstra steps taken appended (the serial chain the kernel
    walks)."""
    r_, c_ = cost.shape
    if r_ > c_:
        raise ValueError("requires rows <= cols; transpose the cost matrix")
    cost = cost.float()
    dev = cost.device
    u = torch.zeros(r_, device=dev)
    v = torch.zeros(c_, device=dev)
    col4row = torch.full((r_,), -1, dtype=torch.int64, device=dev)
    row4col = torch.full((c_,), -1, dtype=torch.int64, device=dev)
    inf = torch.tensor(INF, device=dev)
    taken = 0
    for cur in range(r_):
        spc = torch.full((c_,), INF, device=dev)
        path = torch.full((c_,), -1, dtype=torch.int64, device=dev)
        sr = torch.zeros(r_, dtype=torch.bool, device=dev)
        sc = torch.zeros(c_, dtype=torch.bool, device=dev)
        i, min_val, sink = cur, torch.zeros((), device=dev), -1
        while sink < 0:
            taken += 1
            sr[i] = True
            reduced = min_val + cost[i] - u[i] - v
            better = (~sc) & (reduced < spc)
            path = torch.where(better, torch.full_like(path, i), path)
            spc = torch.where(better, reduced, spc)
            masked = torch.where(sc, inf, spc)
            j = int(torch.argmin(masked))  # the first among equal minima
            min_val = masked[j]
            sc[j] = True
            nxt = int(row4col[j])
            sink = j if nxt < 0 else -1
            i = max(nxt, 0)
        # dual updates
        u[cur] = u[cur] + min_val
        other = sr.clone()
        other[cur] = False
        u = torch.where(other, u + min_val - spc[col4row.clamp(min=0)], u)
        v = torch.where(sc, v - (min_val - spc), v)
        # augment along the alternating path
        while True:
            i = int(path[sink])
            row4col[sink] = i
            old = int(col4row[i])
            col4row[i] = sink
            if i == cur:
                break
            sink = max(old, 0)
    if steps is not None:
        steps.append(taken)
    return col4row.to(torch.int32)


def _masked_cost(cost, row_valid, pad_cost):
    safe = torch.where(row_valid[..., None], cost.float(),
                       torch.full_like(cost, pad_cost, dtype=torch.float32))
    return torch.nan_to_num(safe, nan=pad_cost, posinf=pad_cost,
                            neginf=-pad_cost)


def batched_assignment_plain(cost: torch.Tensor, row_valid: torch.Tensor,
                             pad_cost: float = 1e6,
                             steps: Optional[list] = None) -> torch.Tensor:
    """`batched_assignment`'s plain version: [B, R, C] -> [B, R] int32
    (`steps`: each matrix's Dijkstra steps appended)."""
    safe = _masked_cost(cost, row_valid, pad_cost)
    return torch.stack([linear_sum_assignment_plain(m, steps) for m in safe])


def batched_assignment(cost: torch.Tensor, row_valid: torch.Tensor,
                       pad_cost: float = 1e6) -> torch.Tensor:
    """Per-matrix assignment with invalid (padded) rows at `pad_cost`:
    cost [B, R, C], row_valid [B, R] bool -> col4row [B, R] int32
    (meaningful only where row_valid). CPU tensors run the plain
    version; CUDA tensors launch kernel A, one warp per matrix, at most
    MAX_COLS columns."""
    what = "batched_assignment"
    b, r_, c_ = cost.shape
    if r_ > c_ or tuple(row_valid.shape) != (b, r_):
        raise ValueError(f"{what}: cost {tuple(cost.shape)} and row_valid "
                         f"{tuple(row_valid.shape)} (rows <= cols)")
    if cost.device != row_valid.device:
        raise ValueError(f"{what}: tensors on {cost.device} and "
                         f"{row_valid.device}")
    if cost.device.type == "cpu":
        return batched_assignment_plain(cost, row_valid, pad_cost)
    if cost.device.type != "cuda":
        raise ValueError(f"{what}: expected CPU or CUDA tensors")
    if c_ > MAX_COLS:
        raise ValueError(f"{what}: the kernel takes at most {MAX_COLS} "
                         f"columns, got {c_}")
    # valid rows as `_masked_cost` writes them; padded rows are not read
    # (the kernel costs them at pad_cost)
    safe = torch.nan_to_num(cost.float(), nan=pad_cost, posinf=pad_cost,
                            neginf=-pad_cost).contiguous()
    valid = row_valid.to(torch.bool).contiguous()
    out = torch.empty((b, r_), dtype=torch.int32, device=cost.device)
    if b:
        _kernels.check(_kernels.load("assignment").simpb_lsa(
            _kernels.ptr(safe), _kernels.ptr(valid), _kernels.ptr(out), b,
            r_, c_, float(pad_cost),
            ctypes.c_void_p(_kernels.stream_ptr(safe))), what)
        _LAUNCHES["assignment"] += 1
    return out


def masked_assignment(cost: torch.Tensor, row_valid: torch.Tensor,
                      pad_cost: float = 1e6) -> torch.Tensor:
    """One matrix: cost [R, C], row_valid [R] -> col4row [R] int32."""
    return batched_assignment(cost[None], row_valid[None], pad_cost)[0]


def linear_sum_assignment(cost: torch.Tensor) -> torch.Tensor:
    """One finite matrix [R, C] -> col4row [R] int32."""
    valid = torch.ones(cost.shape[:1], dtype=torch.bool, device=cost.device)
    return masked_assignment(cost, valid)


# the kernel of this module: (name, wrapper, plain version, the TPU op it
# replaces, `lax` loops there)
KERNELS = (
    ("assignment", batched_assignment, batched_assignment_plain,
     "simpb_tpu/training/matching.py:25"),
)


def reset_launch_counts() -> None:
    _LAUNCHES["assignment"] = 0


def launch_counts() -> dict:
    return dict(_LAUNCHES)
