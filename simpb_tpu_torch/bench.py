"""Benchmark: 6-camera streaming inference throughput on one card (port of
the repository's `bench.py`).

    python -m simpb_tpu_torch.bench

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"peak_hbm_gib"}, the keys of `bench.py`. It serves the same default,
`simpb_r50_704x256_fast` with trunk and head in bfloat16, window 128,
bs 1, through `utils/benchmark.py::run_benchmark` on the card. The
port's default trunk is the fused inference trunk (`models/detector.py`),
where `bench.py`'s default is the JAX module trunk; both compute the
same function up to roundings.

`vs_baseline` divides by 12 frames a second, the nuScenes camera rate:
one card must keep up with one car (PERF.md §2). `bench.py` divides by
a TPU v5e target, which is not a number of this port.

Environment switches, as in `bench.py` and with its precedence: the
configuration is `simpb_r50_704x256_guarded` under `SIMPB_GUARDED`, else
`simpb_r50_704x256_fast_guarded` under `SIMPB_FAST_GUARDED`, else
`simpb_r50_704x256_hybrid` (windowed MSDA with an exact correction lane,
guarded) under `SIMPB_HYBRID`, else `simpb_r50_704x256` (exact MSDA)
under `SIMPB_EXACT`, else the default; then `SIMPB_MSDA_PATCH`,
`SIMPB_DFA_CAP`, `SIMPB_MSDA_CAP`, `SIMPB_CLAMP_CAP` (the hybrid's
correction capacity) and `SIMPB_FUSED_TRUNK` (1: the fused trunk, the
port's default; another value: the module trunk at inference, as
`bench.py` sets `backbone_fused_infer`). Under a guarded configuration
the guard counters are computed every frame and charged against the
number (`utils/benchmark.py`).
"""
import dataclasses
import json
import os

from .configs import base
from .utils.benchmark import run_benchmark

BASELINE_FPS = 12.0  # nuScenes camera rate, frames a second
# the configuration switches, highest precedence first (bench.py:29-48)
CONFIG_SWITCHES = (
    ("SIMPB_GUARDED", "simpb_r50_704x256_guarded"),
    ("SIMPB_FAST_GUARDED", "simpb_r50_704x256_fast_guarded"),
    ("SIMPB_HYBRID", "simpb_r50_704x256_hybrid"),
    ("SIMPB_EXACT", "simpb_r50_704x256"),
)


def config_name() -> str:
    """The name of the configuration the switches select."""
    for switch, name in CONFIG_SWITCHES:
        if os.environ.get(switch):
            return name
    return "simpb_r50_704x256_fast"


def config():
    """The served config, from the environment switches."""
    env = os.environ
    name = config_name()
    cfg = dataclasses.replace(
        getattr(base, name)(), compute_dtype="bfloat16",
        head_dtype="bfloat16",
        backbone_fused_infer=env.get("SIMPB_FUSED_TRUNK", "1") == "1",
    )
    head = cfg.head
    if env.get("SIMPB_MSDA_PATCH"):
        head = dataclasses.replace(head, msda_patch_mode=True)
    if env.get("SIMPB_DFA_CAP"):
        head = dataclasses.replace(
            head, dfa_gather_capacity=int(env["SIMPB_DFA_CAP"])
        )
    if env.get("SIMPB_MSDA_CAP"):
        head = dataclasses.replace(
            head, msda_gather_capacity=int(env["SIMPB_MSDA_CAP"])
        )
    if env.get("SIMPB_CLAMP_CAP"):
        head = dataclasses.replace(
            head, msda_clamp_capacity=int(env["SIMPB_CLAMP_CAP"])
        )
    return dataclasses.replace(cfg, head=head)


def result(fps, stats) -> dict:
    """The bench line's object from `run_benchmark`'s (fps, stats)."""
    peak = stats["peak_hbm_bytes"]
    return {
        "metric": "6cam_frames_per_sec_per_chip",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "peak_hbm_gib": round(peak / 2**30, 3) if peak is not None else None,
    }


def main():
    cfg = config()
    fps, stats = run_benchmark(
        cfg, window=128, batch_size=1, return_stats=True
    )
    print(json.dumps(result(fps, stats)))


if __name__ == "__main__":
    main()
