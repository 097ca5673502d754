"""Sequence-aligned evaluation shards (port of
`simpb_tpu/data/sampler.py::sequence_eval_shards`).

Splits the val set at sequence boundaries so each data-parallel shard
streams whole scenes in order (reference
datasets/samplers/distributed_sampler.py:25-82): the instance bank
carries state across consecutive frames. The training samplers come
with the training path (ROADMAP A.2).
"""
from __future__ import annotations

from typing import List

import numpy as np


def sequence_eval_shards(
    dataset, world_size: int, timestamp_gap: float = 4.0
) -> List[List[int]]:
    """Split the (timestamp-sorted) val set at sequence boundaries into
    `world_size` contiguous shards of whole sequences."""
    times = np.array(
        [info["timestamp"] / 1e6 for info in dataset.data_infos]
    )
    boundaries = [0]
    for i in range(1, len(times)):
        if times[i] - times[i - 1] > timestamp_gap:
            boundaries.append(i)
    boundaries.append(len(times))
    sequences = [
        list(range(boundaries[i], boundaries[i + 1]))
        for i in range(len(boundaries) - 1)
    ]
    shards: List[List[int]] = [[] for _ in range(world_size)]
    sizes = [0] * world_size
    for seq in sequences:
        tgt = int(np.argmin(sizes))
        shards[tgt].extend(seq)
        sizes[tgt] += len(seq)
    return shards
