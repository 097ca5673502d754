"""Data parallelism over `torch.distributed`, one process a card (port of
`simpb_tpu/parallel/mesh.py`).

The JAX package runs one program over a `data` mesh (`pjit`), and XLA
inserts the gradient reduction, the loss normalisers' sums and the eval
gathers. The port runs one process a card, as PyTorch does, and makes
each of those collectives explicit with the helpers here:

* `initialize_multihost` joins the process group: NCCL when the
  process's device is a card, gloo on the CPU; the rendezvous is
  `tcp://<coordinator>` when one is given, else the launcher's
  environment (`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`,
  `LOCAL_RANK`, as `torchrun` sets them). A rendezvous that fails
  raises; nothing carries on at world size 1.
* `process_count`, `process_index`, `host_barrier`, `all_reduce_sum_`
  (a list of tensors through one flat buffer, in a fixed order),
  `all_gather_rows` (rank order, tiled along axis 0), `broadcast_float`,
  `any_flag`, and `AllReduceSum`, an all-reduce whose backward is again
  an all-reduce sum (the global batch statistics of BatchNorm).
* `batch_slice_draw`: a random draw whose axis is the local batch draws
  the global shape from the step's generator (the same stream on every
  rank) and keeps this rank's rows, so that a run does not depend on
  how its global batch is split over processes.

JAX's `make_mesh`, `batch_sharding`, `replicated` and `shard_batch`
have no counterpart: each process holds its own rows of the global
batch (the sampler yields `bs_local` items a rank) and nothing is placed
across processes. Camera-axis sharding (`cam` meshes) is not ported
(ROADMAP A.5).

Without a process group every helper is the identity: that is world 1,
not a fallback. A collective that fails raises; none is caught here.
"""
from __future__ import annotations

import datetime
import os
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# seconds a rendezvous and each collective may wait for the other ranks
INIT_TIMEOUT_S = 600.0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def _local_rank(process_id: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(torch.cuda.device_count(), 1)


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: Optional[str] = None,
                         timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group and return this process's device.

    `coordinator` ("host:port") with `num_processes` and `process_id`
    names the rendezvous; without it the launcher's environment does.
    `device` None takes `cuda:<local rank>` (LOCAL_RANK, else the
    process id modulo the cards); "cpu" takes the gloo backend. Raises
    when the rendezvous does not complete within `timeout_s` (default
    INIT_TIMEOUT_S). Then one barrier and a one-element all-reduce run
    while the processes are aligned (`warm_mesh_collectives`)."""
    if is_initialized():
        raise RuntimeError("the process group is already initialised")
    timeout = datetime.timedelta(
        seconds=INIT_TIMEOUT_S if timeout_s is None else timeout_s)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        init_method = f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                               "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(
                "multi-process run without --coordinator: the launcher "
                f"set no {', '.join(missing)} (start it with torchrun, or "
                "pass --coordinator, --num-processes and --process-id)")
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to "
                               "train on the CPU over gloo")
        dev = torch.device("cuda", _local_rank(rank))
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    warm_mesh_collectives()
    return dev


def warm_mesh_collectives() -> None:
    """A barrier and a one-element all-reduce right after the
    rendezvous, so that the communicators exist before the first step."""
    host_barrier("simpb_mesh_warmup")
    all_reduce_sum_([torch.zeros(1, device=_collective_device())])


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()


def _collective_device() -> torch.device:
    """Where a helper places the tensors it creates: the current card
    under NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_barrier(name: str) -> None:
    """Align every process here (no-op without a process group). `name`
    labels the barrier in the error a timeout raises."""
    if not is_initialized():
        return
    flag = torch.zeros(1, device=_collective_device())
    try:
        dist.all_reduce(flag)
        flag.item()  # the host waits for the collective
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place, through one flat buffer
    a dtype, the tensors in the list's order (every rank passes the same
    list of shapes and dtypes)."""
    if not is_initialized():
        return
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        at = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[at:at + n].view_as(t))
            at += n


class AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; the gradient of x is the sum of
    the ranks' gradients of y (each rank's loss takes its share of y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """`AllReduceSum` under a process group, `x` itself without one."""
    return AllReduceSum.apply(x) if is_initialized() else x


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` (equal shapes), tiled along axis 0 in rank order.
    bool tensors travel as uint8. Under gloo a card's tensor is staged
    through host memory (gloo's collectives are host collectives)."""
    if not is_initialized():
        return x
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    if dist.get_backend() == "gloo":
        src = src.cpu()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    out = torch.cat(parts).to(x.device)
    return out.bool() if x.dtype == torch.bool else out


def broadcast_float(value: float, src: int = 0) -> float:
    """Rank `src`'s `value` on every rank (float64)."""
    if not is_initialized():
        return float(value)
    t = torch.tensor([value], dtype=torch.float64,
                     device=_collective_device())
    dist.broadcast(t, src)
    return float(t.item())


def any_flag(flag: bool) -> bool:
    """True on every rank when `flag` is true on any."""
    if not is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_collective_device())
    dist.all_reduce(t)
    return bool(t.item())


def batch_slice_draw(draw: Callable[[tuple], torch.Tensor],
                     shape: Sequence[int], axis: int = 0) -> torch.Tensor:
    """`draw(shape)` for a random tensor whose `axis` is the local batch
    (batch-major along it): at world W it draws the global shape, that
    axis W times as long, and keeps this rank's rows, so that every rank
    draws the same stream and the ranks' rows together are the draw of
    the global batch. At world 1 it is `draw(shape)`."""
    world = process_count()
    shape = tuple(int(s) for s in shape)
    if world == 1:
        return draw(shape)
    n = shape[axis]
    full = shape[:axis] + (n * world,) + shape[axis + 1:]
    return draw(full).narrow(axis, process_index() * n, n)


def check_replicated(tensors: List[torch.Tensor], what: str) -> None:
    """Raise unless every rank holds the same `tensors` (rank 0's
    checksum broadcast and compared on each rank)."""
    if not is_initialized():
        return
    # the values' sum and their magnitudes' sum weighted by position
    mine = [sum(float(t.detach().double().sum()) for t in tensors),
            sum(float(t.detach().double().abs().sum()) * (i + 1)
                for i, t in enumerate(tensors))]
    ref = [broadcast_float(v) for v in mine]
    if not any_flag(mine != ref):
        return
    raise RuntimeError(f"{what} differ across ranks (checksum {mine} on "
                       f"rank {process_index()}, rank 0 {ref})")
