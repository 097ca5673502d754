"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source `simpb_tpu_torch/csrc/<name>.cu` compiles, at first use, into
`build/simpb_tpu_torch/lib<name>-<hash>.so` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

The hash covers the source, so an edited source builds anew. Processes
that start together (the ranks of a data-parallel run) build each
library once: the build holds an exclusive `fcntl.flock` on
`build/simpb_tpu_torch/lock` around `nvcc` and the rename, and a
process that waited on it finds the library built. Functions
have a plain C interface: every pointer and the stream pass as
`ctypes.c_void_p`, every int as `ctypes.c_int`, and each returns the
`cudaGetLastError()` code of its launch. Nothing here runs at import
time: the CPU tests import every module on a host without `nvcc`.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

MAX_SMEM = 227 * 1024  # dynamic shared memory a block may use (H100)
PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "simpb_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

P, I = ctypes.c_void_p, ctypes.c_int
# C signatures: source name -> {function: (argtypes, restype)}
PROBE_SIG = ((P, P, I, I, I, I, P), I)  # x, y, N, H, W, C, stream
SIGNATURES = {
    "assignment": {
        # cost, row_valid, col4row, B, R, C, pad cost, stream
        "simpb_lsa": ((P, P, P, I, I, I, ctypes.c_float, P), I),
        # out, n, C, stream
        "simpb_lsa_argmin_chain": ((P, I, I, P), I),
    },
    "conv_fused": {
        "simpb_maxpool_3x3_s2": ((P, P, I, I, I, I, I, P), I),
        "simpb_bottleneck": (
            (P,) * 10 + (I,) * 10 + (P,), I,
        ),
        "simpb_conv3x3_bias": ((P, P, P, P) + (I,) * 8 + (P,), I),
    },
    "conv_tc": {
        # x, w, bias, y; B, H, W, C, Co, th, tw, mt, bk, wm, smem;
        # stream
        "simpb_conv3x3_tc": ((P,) * 4 + (I,) * 11 + (P,), I),
        # x, w1, b1, w2, b2, w3, b3, y; B, H, W, C, Cm, th, tw, mt, bk,
        # wm a/b/c, smem; stream
        "simpb_bottleneck_tc": ((P,) * 8 + (I,) * 13 + (P,), I),
        # x, w1, b1, w2, b2, w3, b3, wd, bd, y; B, H, W, C, Cm, Co,
        # stride, th, tw, mt, bk, wm a/b/c, smem; stream
        "simpb_bottleneck_down_tc": ((P,) * 10 + (I,) * 15 + (P,), I),
    },
    "mosaic_probe": {
        "simpb_probe_lane": PROBE_SIG,
        "simpb_probe_chunk": PROBE_SIG,
        "simpb_probe_reshape": PROBE_SIG,
        "simpb_probe_outer": PROBE_SIG,
        "simpb_probe_refshape": PROBE_SIG,
        "simpb_probe_chunk_flat": PROBE_SIG,
    },
    "sampling": {
        # col, points, weights, counted, out, dims (host int[]), strides
        # (host int64[]), dtype, stream
        "simpb_dfa": ((P,) * 7 + (I, P), I),
        # value, loc, attw, sampled, wsum, dims (host int[]), dtype, stream
        "simpb_msda_sel": ((P,) * 6 + (I, P), I),
        # value, loc, attw, sampled, wsum, dims (host int[]), dtype, stream
        "simpb_msda": ((P,) * 6 + (I, P), I),
        # the same, then samples in flight, probe mode, stream (bf16)
        "simpb_msda_probe": ((P,) * 6 + (I, I, P), I),
        # value, loc, attw, sel, sampled, wsum (in place), dims, dtype,
        # stream
        "simpb_msda_hybrid": ((P,) * 7 + (I, P), I),
        # value, loc, attw, sampled, wsum, dims, stream (H1, bf16)
        "simpb_msda_levels": ((P,) * 6 + (P,), I),
        # loc, attw, sel, attw_win, dims, k_cap, stream (H3, the op's)
        "simpb_clamp_select": ((P,) * 5 + (I, P), I),
        # loc, valid (or NULL), demand, dims, stream (H3, the guards')
        "simpb_clamp_demand": ((P,) * 4 + (P,), I),
        # col, points, weights, thresholds, grad out, grad col, grad
        # points, grad weights, scratch, dims, strides, dtype, stages,
        # stream
        "simpb_dfa_bwd": ((P,) * 11 + (I, I, P), I),
        # value, loc, attw, grad sampled, grad wsum, grad value, grad loc,
        # grad attw, scratch, dims, dtype, stream
        "simpb_msda_sel_bwd": ((P,) * 10 + (I, P), I),
        # value, loc, attw, grad sampled, grad wsum, grad value, grad loc,
        # grad attw, scratch, dims, dtype, stages, first tile, end tile,
        # stream
        "simpb_msda_bwd": ((P,) * 10 + (I, I, I, I, P), I),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on the build directory (one build at a time
    among the processes sharing it); released when the holder exits,
    however it exits."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names: Sequence[str]) -> List[Path]:
    """Compile each `csrc/<name>.cu` whose library is not up to date, one
    `nvcc` per source, all started together, under the build lock; keeps
    each `-Xptxas -v` report beside its library. Raises with the
    compiler's output on failure."""
    outs = [library_path(n) for n in names]
    if all(out.exists() for out in outs):
        return outs
    with _build_lock():
        return _build_missing(names, outs)


def _build_missing(names: Sequence[str], outs: List[Path]) -> List[Path]:
    procs = []
    for name, out in zip(names, outs):
        if out.exists():  # built by the process that held the lock
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        procs.append((name, out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library is up to date."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's device address for a `void*` argument (NULL for None)."""
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def int_array(values: Sequence[int], ctype=ctypes.c_int):
    """A host array for a `const int*` (or `const long long*`) argument."""
    return (ctype * len(values))(*values)
