"""Temporal batch sampling for streaming training and sequence-aligned
evaluation (port of `simpb_tpu/data/sampler.py`).

* `GroupStreamSampler`: the SOLOFusion-style infinite stream sampler
  (reference datasets/samplers/group_in_batch_sampler.py:48-178): each of
  the `batch_size * world_size` global slots walks its own
  (sub-)sequence in order, refilling from a seed-synced shuffled
  permutation of groups, with `skip_prob` frame skipping and
  `sequence_flip_prob` reversal; it yields (idx, aug_config, new_seq)
  so that the augmentation stays constant within a sequence. Its draws
  come in the JAX package's order on its own generator.
* `group_epoch_indices`: the epoch-based group-aligned shuffle
  (reference datasets/samplers/group_sampler.py:13-119).
* `sequence_eval_shards`: splits the val set at sequence boundaries so
  each data-parallel shard streams whole scenes in order (reference
  datasets/samplers/distributed_sampler.py:25-82): the instance bank
  carries state across consecutive frames.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class GroupStreamSampler:
    def __init__(
        self,
        dataset,
        batch_size: int,
        world_size: int = 1,
        rank: int = 0,
        seed: int = 0,
        skip_prob: float = 0.5,
        sequence_flip_prob: float = 0.1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.world_size = world_size
        self.rank = rank
        self.rng = np.random.default_rng(seed)  # seed shared across ranks
        self.skip_prob = skip_prob
        self.sequence_flip_prob = sequence_flip_prob

        flags = dataset.flag
        self.groups = [
            np.where(flags == g)[0] for g in np.unique(flags)
        ]
        self.global_slots = batch_size * world_size
        self._perm: List[int] = []
        # per-global-slot state: (group_frames, cursor, aug_config)
        self._slot: List[Optional[Tuple[np.ndarray, int, Dict]]] = [
            None
        ] * self.global_slots

    def _next_group(self) -> np.ndarray:
        if not self._perm:
            self._perm = list(self.rng.permutation(len(self.groups)))
        g = self.groups[self._perm.pop()]
        if self.rng.uniform() < self.sequence_flip_prob:
            g = g[::-1]
        return g

    def _advance_slot(self, s: int) -> Tuple[int, Dict, bool]:
        st = self._slot[s]
        new_seq = st is None or st[1] >= len(st[0])
        if new_seq:
            frames = self._next_group()
            aug = self.dataset.get_augmentation(self.rng)
            st = (frames, 0, aug)
        frames, cur, aug = st
        idx = int(frames[cur])
        step = 1
        if (
            self.skip_prob > 0
            and cur + 2 < len(frames)
            and self.rng.uniform() < self.skip_prob
        ):
            step = 2
        self._slot[s] = (frames, cur + step, aug)
        return idx, aug, new_seq

    def __iter__(self) -> Iterator[List[Tuple[int, Dict, bool]]]:
        """Yields per-rank batches of (frame_idx, aug_config, new_seq);
        `new_seq` marks the first frame of a slot's (sub-)sequence so the
        temporal stream can be broken there."""
        while True:
            # advance every global slot with the shared RNG (keeps ranks
            # in lockstep like the reference's broadcast seed), keep ours
            batch_all = [
                self._advance_slot(s) for s in range(self.global_slots)
            ]
            lo = self.rank * self.batch_size
            yield batch_all[lo : lo + self.batch_size]


def group_epoch_indices(
    flags: np.ndarray,
    samples_per_device: int,
    num_replicas: int = 1,
    rank: int = 0,
    epoch: int = 0,
    seed: int = 0,
) -> np.ndarray:
    """Epoch-based group-aligned shuffle (the reference's fallback
    `DistributedGroupSampler`, datasets/samplers/group_sampler.py:13-119).

    Semantics preserved: per-group permutation, circular padding of each
    group to a multiple of `samples_per_device * num_replicas`, shuffle
    at `samples_per_device`-chunk granularity (so every per-device batch
    is drawn from a single group), then a contiguous per-rank slice.
    Deterministic in (epoch, seed) and identical across ranks, like the
    reference's `torch.Generator().manual_seed(epoch + seed)`. Returns
    this rank's frame indices for the epoch.
    """
    flags = np.asarray(flags)
    rng = np.random.default_rng(epoch + seed)
    quantum = samples_per_device * num_replicas

    indices: List[int] = []
    for g in np.unique(flags):
        members = np.where(flags == g)[0]
        perm = members[rng.permutation(len(members))].tolist()
        extra = -len(perm) % quantum
        padded = perm + (perm * (extra // len(perm) + 1))[:extra]
        indices.extend(padded)

    chunks = np.asarray(indices, dtype=np.int64).reshape(
        -1, samples_per_device
    )
    chunks = chunks[rng.permutation(len(chunks))]
    indices = chunks.reshape(-1)

    num_samples = len(indices) // num_replicas
    return indices[rank * num_samples : (rank + 1) * num_samples]


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
