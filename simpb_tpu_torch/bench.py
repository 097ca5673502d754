"""Benchmark: 6-camera streaming inference throughput on one card (port of
the repository's `bench.py`).

    python -m simpb_tpu_torch.bench

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"peak_hbm_gib"}, the keys of `bench.py`. It serves the same default,
`simpb_r50_704x256_fast` with trunk and head in bfloat16, window 128,
bs 1, through `utils/benchmark.py::run_benchmark` on the card. The
port's trunk is always the fused inference trunk (`models/detector.py`),
where `bench.py`'s default is the JAX module trunk; both compute the
same function.

`vs_baseline` divides by 12 frames a second, the nuScenes camera rate:
one card must keep up with one car (PERF.md §2). `bench.py` divides by
a TPU v5e target, which is not a number of this port.

Environment switches, as in `bench.py`: `SIMPB_MSDA_PATCH`,
`SIMPB_DFA_CAP`, `SIMPB_MSDA_CAP` and `SIMPB_FUSED_TRUNK=1` are taken.
`SIMPB_GUARDED`, `SIMPB_FAST_GUARDED`, `SIMPB_HYBRID`, `SIMPB_EXACT`,
`SIMPB_CLAMP_CAP` and `SIMPB_FUSED_TRUNK` of another value select
settings the port does not serve yet: the bench exits non-zero and
names them, and never falls back to the default.
"""
import dataclasses
import json
import os

from .configs.base import simpb_r50_704x256_fast
from .utils.benchmark import run_benchmark

BASELINE_FPS = 12.0  # nuScenes camera rate, frames a second
NOT_PORTED = ("SIMPB_GUARDED", "SIMPB_FAST_GUARDED", "SIMPB_HYBRID",
              "SIMPB_EXACT", "SIMPB_CLAMP_CAP")


def config():
    """The served config, from the environment switches; SystemExit
    naming every switch the port does not serve yet."""
    env = os.environ
    refused = [k for k in NOT_PORTED if env.get(k)]
    if env.get("SIMPB_FUSED_TRUNK") and env["SIMPB_FUSED_TRUNK"] != "1":
        refused.append("SIMPB_FUSED_TRUNK=" + env["SIMPB_FUSED_TRUNK"])
    if refused:
        raise SystemExit(
            f"not ported: {', '.join(refused)} (the port serves "
            "simpb_r50_704x256_fast with the fused trunk; see ROADMAP.md)"
        )
    cfg = dataclasses.replace(
        simpb_r50_704x256_fast(), compute_dtype="bfloat16",
        head_dtype="bfloat16", backbone_fused_infer=True,
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
