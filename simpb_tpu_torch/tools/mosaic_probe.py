"""The strided-copy probes of `tools/mosaic_probe.py`, on Hopper.

    python -m simpb_tpu_torch.tools.mosaic_probe [--device cpu]

The JAX tool asked which strided VMEM loads the TPU compiler could lower.
Each of its six Pallas probes is here a hand-written CUDA kernel
(`csrc/mosaic_probe.cu`) doing the same staging and selection, with a
plain PyTorch version beside it. The tool feeds every probe the JAX
tool's input (`mk`: an arange over the size, in bf16) and prints one line
per probe under the JAX tool's labels: OK or WRONG against the plain
version, and the kernel's time (CUDA events over `ITERS` calls). A WRONG
result raises. On the card unless `--device cpu` is given; on the CPU
the wrappers run the plain versions and nothing is timed.
"""
from __future__ import annotations

import argparse
import ctypes
from typing import List, Optional

import torch

from ..ops import _kernels
from ..utils.device import resolve_device

H = W = 16  # the probes' spatial size
CHUNK = 128  # channel chunk of P2 / P7 (a TPU lane row)
ITERS = 20  # timed calls per probe on the card


def mk(shape, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """The JAX tool's input: arange(size) / size, cast to `dtype`."""
    n = 1
    for d in shape:
        n *= d
    x = torch.arange(n, dtype=torch.float32, device=device).reshape(shape)
    return (x / n).to(dtype)


# ----------------------------------------------------------------------
# plain versions: what each Pallas body computes (and the `ref` it is
# checked against), staged through fp32 where the body stages
# ----------------------------------------------------------------------
def p_lane_plain(x: torch.Tensor) -> torch.Tensor:
    return x.float()[:, ::2, ::2].to(x.dtype)


def p_chunk_plain(x: torch.Tensor) -> torch.Tensor:
    chunks = [x[..., g:g + CHUNK].float()[:, ::2, ::2]
              for g in range(0, x.shape[-1], CHUNK)]
    return torch.cat(chunks, -1).to(x.dtype)


def p_reshape_plain(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c)[:, :, 0, :, 0].contiguous()


def p_outer_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    return x[:, ::2].contiguous()


def p_refshape_plain(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.float().reshape(n, h, w // 2, 2, c)[:, :, :, 0].to(x.dtype)


def p_chunk_flat_plain(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    flat = torch.cat([x[..., g:g + CHUNK].float()
                      for g in range(0, c, CHUNK)], 1)  # [n, G*H, W, 128]
    out = [flat[:, g * h:(g + 1) * h:2, ::2] for g in range(c // CHUNK)]
    return torch.cat(out, -1).to(x.dtype)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def _launch(fn: str, x: torch.Tensor, out_hw, what: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous bf16 NHWC tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    n, h, w, c = x.shape
    y = torch.empty((n,) + out_hw + (c,), dtype=x.dtype, device=x.device)
    lib = _kernels.load("mosaic_probe")
    code = getattr(lib, fn)(_kernels.ptr(x), _kernels.ptr(y), n, h, w, c,
                            ctypes.c_void_p(_kernels.stream_ptr(x)))
    _kernels.check(code, what)
    return y


def _half(n: int) -> int:
    return (n + 1) // 2


def _need(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def p_lane(x: torch.Tensor) -> torch.Tensor:
    """P1: [::2, ::2] through an fp32 staging of the whole tile."""
    if x.device.type == "cpu":
        return p_lane_plain(x)
    y = _launch("simpb_probe_lane", x, (_half(x.shape[1]), _half(x.shape[2])),
                "p_lane")
    p_lane.launches += 1
    return y


def p_chunk(x: torch.Tensor) -> torch.Tensor:
    """P2: [::2, ::2] through an fp32 [G, H, W, 128] chunk staging."""
    if x.device.type == "cpu":
        return p_chunk_plain(x)
    _need(x.shape[-1] % CHUNK == 0, "p_chunk", f"C must be a multiple of "
          f"{CHUNK}, got {x.shape[-1]}")
    y = _launch("simpb_probe_chunk", x,
                (_half(x.shape[1]), _half(x.shape[2])), "p_chunk")
    p_chunk.launches += 1
    return y


def p_reshape(x: torch.Tensor) -> torch.Tensor:
    """P4: [::2, ::2] as a reshape with unit selects, straight from x."""
    if x.device.type == "cpu":
        return p_reshape_plain(x)
    _need(x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0, "p_reshape",
          f"H and W must be even, got {tuple(x.shape)}")
    y = _launch("simpb_probe_reshape", x, (x.shape[1] // 2, x.shape[2] // 2),
                "p_reshape")
    p_reshape.launches += 1
    return y


def p_outer_bf16(x: torch.Tensor) -> torch.Tensor:
    """P5: the row stride [::2] alone, bf16 straight from x."""
    if x.device.type == "cpu":
        return p_outer_bf16_plain(x)
    y = _launch("simpb_probe_outer", x, (_half(x.shape[1]), x.shape[2]),
                "p_outer_bf16")
    p_outer_bf16.launches += 1
    return y


def p_refshape(x: torch.Tensor) -> torch.Tensor:
    """P6: the column stride via an fp32 [H, W/2, 2, C] staging."""
    if x.device.type == "cpu":
        return p_refshape_plain(x)
    _need(x.shape[2] % 2 == 0, "p_refshape",
          f"W must be even, got {x.shape[2]}")
    y = _launch("simpb_probe_refshape", x, (x.shape[1], x.shape[2] // 2),
                "p_refshape")
    p_refshape.launches += 1
    return y


def p_chunk_flat(x: torch.Tensor) -> torch.Tensor:
    """P7: [::2, ::2] via an fp32 [G*H, W, 128] flat chunk staging."""
    if x.device.type == "cpu":
        return p_chunk_flat_plain(x)
    _need(x.shape[-1] % CHUNK == 0, "p_chunk_flat", f"C must be a multiple "
          f"of {CHUNK}, got {x.shape[-1]}")
    y = _launch("simpb_probe_chunk_flat", x,
                (_half(x.shape[1]), _half(x.shape[2])), "p_chunk_flat")
    p_chunk_flat.launches += 1
    return y


# (label of the JAX tool, wrapper, plain version, channels, the Pallas
# call it replaces)
PROBES = (
    ("P1_lane64", p_lane, p_lane_plain, 64, "tools/mosaic_probe.py:47"),
    ("P1_lane256", p_lane, p_lane_plain, 256, "tools/mosaic_probe.py:47"),
    ("P2_chunk4d", p_chunk, p_chunk_plain, 256, "tools/mosaic_probe.py:75"),
    ("P4_value_reshape", p_reshape, p_reshape_plain, 256,
     "tools/mosaic_probe.py:98"),
    ("P5_outer_stride_bf16", p_outer_bf16, p_outer_bf16_plain, 256,
     "tools/mosaic_probe.py:118"),
    ("P6_ref_reshape_unit_select", p_refshape, p_refshape_plain, 256,
     "tools/mosaic_probe.py:141"),
    ("P7_chunk_flat3d", p_chunk_flat, p_chunk_flat_plain, 256,
     "tools/mosaic_probe.py:171"),
)
WRAPPERS = (p_lane, p_chunk, p_reshape, p_outer_bf16, p_refshape,
            p_chunk_flat)
for _wrapper in WRAPPERS:
    _wrapper.launches = 0


def reset_launch_counts() -> None:
    for wrapper in WRAPPERS:
        wrapper.launches = 0


def launch_counts() -> dict:
    return {wrapper.__name__: wrapper.launches for wrapper in WRAPPERS}


def _kernel_ms(fn, x: torch.Tensor) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def run(device=None) -> List[dict]:
    """Every probe once against its plain version (and, on the card,
    timed): prints one line each, raises on a wrong result. Returns
    [{label, channels, ok, max_abs_err, ms, launches}]."""
    dev = resolve_device(device)
    results = []
    for label, wrapper, plain, c, _ in PROBES:
        x = mk((1, H, W, c), device=dev)
        before = wrapper.launches
        out = wrapper(x)
        ref = plain(x)
        ok = out.shape == ref.shape and torch.equal(out, ref)
        err = ((out.float() - ref.float()).abs().max().item()
               if out.shape == ref.shape else float("inf"))
        ms: Optional[float] = None
        if dev.type == "cuda" and ok:
            ms = _kernel_ms(wrapper, x)
        timing = f"{ms:.4f} ms" if ms is not None else "plain version, untimed"
        print(f"{label}: {'OK' if ok else f'WRONG {err}'} ({timing})",
              flush=True)
        if not ok:
            raise AssertionError(f"{label}: kernel differs from its plain "
                                 f"version by {err}")
        results.append(dict(label=label, channels=c, ok=ok, max_abs_err=err,
                            ms=ms, launches=wrapper.launches - before))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    run(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
