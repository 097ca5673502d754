"""The sampling guard counters of the capped and windowed configurations
(port of `simpb_tpu/utils/guards.py`).

With `guard_sampling` the head's serving forward fills a collector, a
dict of {counter name: [one value per layer]} (`models/dfa.py`,
`models/group_attn.py`; JAX sows the same counters into its flax
"guards" collection). `summarize_guards` reduces it to each counter's
maximum over the layers, on the device; `training/evaluate.py` attaches
those as the decode's `guard_*` entries and `streaming_eval` reduces
them over frames with `merge_guard_maxima`. A counter at 0 means the
frame's sampling was exactly the uncapped, unwindowed semantics:

  dfa_overflow              in-range DFA (anchor, point) slots a camera
                            holds beyond `dfa_gather_capacity`
  msda_overflow             valid 2D slots beyond `msda_gather_capacity`
  msda_window_clamped       windowed samples whose bilinear stencil the
                            window does not serve whole
  msda_window_clamped_mass  attention mass on those samples
  msda_level_dropped_mass   attention mass on levels the top-k drops
  msda_clamp_overflow       (hybrid) window-clamped (query, level) entries
                            a camera holds beyond `msda_clamp_capacity`
  msda_clamp_demand         (hybrid) the most such entries of a camera: a
                            headroom statistic, not a violation
  msda_percam_clamp_demand  (hybrid) each camera's such entries (its
                            maximum is the demand; not a violation)
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def summarize_guards(tree) -> Dict[str, torch.Tensor]:
    """{name: maximum over its values} of a collector; nested dicts are
    walked, and equal names anywhere reduce together. The maxima stay
    0-d tensors on their device (no host sync)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
                continue
            for x in (v if isinstance(v, (tuple, list)) else (v,)):
                m = torch.as_tensor(x).float().max()
                out[k] = torch.maximum(out[k], m) if k in out else m

    walk(tree)
    return out


def merge_guard_maxima(a: Dict[str, float],
                       b: Dict[str, float]) -> Dict[str, float]:
    """Max-merge two host-side guard summaries (across frames)."""
    out = dict(a)
    for k, v in b.items():
        out[k] = max(out.get(k, 0.0), float(v))
    return out


def check_guard_violations(metrics: Dict[str, float]) -> list:
    """The `guard_*` metric names whose maxima are nonzero, sorted: at
    least one frame's sampling left the exact semantics the guarded
    configurations promise. `*_demand` entries are headroom statistics,
    not violations; NaN (no frame evaluated) is none either."""
    return sorted(
        k for k, v in metrics.items()
        if k.startswith("guard_") and not k.endswith("_demand")
        and v is not None and not math.isnan(float(v)) and float(v) != 0.0
    )
