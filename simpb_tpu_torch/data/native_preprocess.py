"""ctypes binding of the native (C++) preprocessing core (port of
`simpb_tpu/data/native_preprocess.py`).

`csrc/preprocess.cpp` of this package compiles with g++ at first use
into `build/simpb_tpu_torch/libpreprocess-<hash>.so` (the hash covers
the source) and exposes the fused resize+crop+flip+normalise pass and
`native_hang`, the fault injection of the watchdog tests. When
no compiler is there, `available()` is False and the dataset takes the
PIL path (`data/transforms.py`), as in the JAX package.

The native resize is bilinear; the reference's PIL default is bicubic,
a distribution-level difference only. `use_native=False` on the dataset
keeps the PIL path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from ..ops._kernels import BUILD_DIR, CSRC_DIR
from .transforms import IMG_MEAN, IMG_STD

_SRC = CSRC_DIR / "preprocess.cpp"
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _build() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when g++ fails or is
    missing (the failure is not retried)."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libpreprocess-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                check=True, capture_output=True,
            )
        except (subprocess.CalledProcessError, FileNotFoundError):
            _failed = True
            return None
        os.replace(tmp, out)  # other processes may build it at once
    lib = ctypes.CDLL(str(out))
    lib.resize_crop_flip_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.resize_crop_flip_normalize.restype = None
    lib.native_hang.argtypes = [ctypes.c_double]
    lib.native_hang.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _build() is not None


def native_hang(seconds: float) -> bool:
    """Fault injection: block the calling thread in native code for
    `seconds`, restarting through EINTR (`csrc/preprocess.cpp`), as a
    stalled native device wait does, so that tests can show the
    preemption watchdog (`utils/watchdog.py`) fires. Returns False when
    the native library is unavailable."""
    lib = _build()
    if lib is None:
        return False
    lib.native_hang(ctypes.c_double(float(seconds)))
    return True


def preprocess_image(
    img: np.ndarray, aug: dict,
    mean: np.ndarray = IMG_MEAN, std: np.ndarray = IMG_STD,
) -> Optional[np.ndarray]:
    """uint8 [H, W, 3] -> normalised float32 network input, or None when
    the native library is unavailable."""
    lib = _build()
    if lib is None:
        return None
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {img.shape}")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    crop = aug["crop"]
    out_w = crop[2] - crop[0]
    out_h = crop[3] - crop[1]
    out = np.empty((out_h, out_w, 3), np.float32)
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    lib.resize_crop_flip_normalize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[0], img.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_h, out_w,
        ctypes.c_float(aug.get("resize", 1.0)),
        int(crop[0]), int(crop[1]),
        int(bool(aug.get("flip", False))),
        mean32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
