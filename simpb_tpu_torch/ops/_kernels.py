"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source `simpb_tpu_torch/csrc/<name>.cu` compiles, at first use, into
`build/simpb_tpu_torch/lib<name>-<hash>.so` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

The hash covers the source, so an edited source builds anew. Functions
have a plain C interface: every pointer and the stream pass as
`ctypes.c_void_p`, every int as `ctypes.c_int`, and each returns the
`cudaGetLastError()` code of its launch. Nothing here runs at import
time: the CPU tests import every module on a host without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "simpb_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

P, I = ctypes.c_void_p, ctypes.c_int
# C signatures: name -> (argtypes, restype)
SIGNATURES = {
    "conv_fused": {
        "simpb_maxpool_3x3_s2": ((P, P, I, I, I, I, I, P), I),
        "simpb_bottleneck": (
            (P,) * 10 + (I,) * 10 + (P,), I,
        ),
        "simpb_conv3x3_bias": ((P, P, P, P) + (I,) * 8 + (P,), I),
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


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library is up to date, keeping
    the `-Xptxas -v` report beside it. Raises with the compiler's output
    on failure."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
         str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(proc.stdout)
    return out


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


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
