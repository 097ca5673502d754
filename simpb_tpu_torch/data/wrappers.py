"""Dataset wrappers: Concat / Repeat / class-balanced (CBGS) resampling
(port of `simpb_tpu/data/wrappers.py`; numpy only, the port's own copy).

The reference dispatches to mmdet ConcatDataset / RepeatDataset and
mmdet3d CBGSDataset (reference datasets/builder.py:154-192). No released
SimPB config uses them, and the training CLI does not import them; they
are here for a config that does.

Every wrapper duck-types `NuScenesDataset` (`data/dataset.py`): it has
`__len__`, `flag` (the sequence-group ids the samplers of
`data/sampler.py` read), `data_infos`, `CLASSES`, `test_mode`,
`get_augmentation`, `get_sample(idx, ...)` and `get_annotations(idx)`
through an index map, so the samplers take a wrapper unchanged, and
wrappers nest (`ClassBalancedDataset(ConcatDataset([...]))`).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


class _Remapped:
    """Shared delegation through an index map onto one base dataset."""

    def __init__(self, dataset, indices: np.ndarray, flag: np.ndarray):
        self.dataset = dataset
        self.indices = np.asarray(indices, np.int64)
        self.flag = np.asarray(flag, np.int64)
        self.CLASSES = dataset.CLASSES
        self.test_mode = dataset.test_mode
        self.use_valid_flag = getattr(dataset, "use_valid_flag", True)
        # reference list (cheap): samplers index `data_infos` directly
        # (e.g. sequence_eval_shards, data/sampler.py:146)
        self.data_infos = [
            dataset.data_infos[int(i)] for i in self.indices
        ]

    def __len__(self):
        return len(self.indices)

    def get_augmentation(self, rng=None):
        return self.dataset.get_augmentation(rng)

    def get_sample(self, idx: int, **kwargs):
        return self.dataset.get_sample(int(self.indices[idx]), **kwargs)

    def get_annotations(self, idx: int):
        return self.dataset.get_annotations(int(self.indices[idx]))


class RepeatDataset(_Remapped):
    """Repeat a dataset `times` times (mmdet RepeatDataset semantics:
    the group `flag` is tiled, so the i-th repeat of a sequence carries
    the SAME group id — repeats are more epochs, not new sequences)."""

    def __init__(self, dataset, times: int):
        n = len(dataset)
        indices = np.tile(np.arange(n, dtype=np.int64), times)
        flag = np.tile(np.asarray(dataset.flag, np.int64), times)
        super().__init__(dataset, indices, flag)
        self.times = times


class ConcatDataset:
    """Concatenate datasets (mmdet ConcatDataset semantics). Group ids
    are offset per sub-dataset so sequences never merge across them."""

    def __init__(self, datasets: Sequence):
        assert len(datasets) > 0
        self.datasets = list(datasets)
        self.CLASSES = self.datasets[0].CLASSES
        self.test_mode = self.datasets[0].test_mode
        self.use_valid_flag = getattr(
            self.datasets[0], "use_valid_flag", True
        )
        self.data_infos = [
            info for d in self.datasets for info in d.data_infos
        ]
        lens = [len(d) for d in self.datasets]
        self.cum = np.cumsum([0] + lens)
        flags, offset = [], 0
        for d in self.datasets:
            f = np.asarray(d.flag, np.int64)
            flags.append(f + offset)
            offset += int(f.max()) + 1 if len(f) else 0
        self.flag = np.concatenate(flags)

    def __len__(self):
        return int(self.cum[-1])

    def _locate(self, idx: int):
        ds = int(np.searchsorted(self.cum, idx, side="right") - 1)
        return self.datasets[ds], idx - int(self.cum[ds])

    def get_augmentation(self, rng=None):
        return self.datasets[0].get_augmentation(rng)

    def get_sample(self, idx: int, **kwargs):
        d, local = self._locate(idx)
        return d.get_sample(local, **kwargs)

    def get_annotations(self, idx: int):
        d, local = self._locate(idx)
        return d.get_annotations(local)


def _sample_cat_ids(dataset, idx: int) -> List[int]:
    """Class ids present in frame `idx`, using the same validity mask as
    annotation assembly (`dataset.py::_add_annotations`)."""
    info = dataset.data_infos[idx]
    mask = (
        info["valid_flag"]
        if getattr(dataset, "use_valid_flag", True) and "valid_flag" in info
        else info["num_lidar_pts"] > 0
    )
    names = np.asarray(info["gt_names"])[np.asarray(mask, bool)]
    return sorted(
        {dataset.CLASSES.index(n) for n in names if n in dataset.CLASSES}
    )


class ClassBalancedDataset(_Remapped):
    """CBGS resampling (mmdet3d CBGSDataset, Zhu et al. 2019): duplicate
    frames so every class contributes ~1/num_classes of the epoch.

    For each class c with sample list S_c, draws
    `len(S_c) * (1/num_classes) / f_c` samples from S_c (f_c = the
    class's share of all (sample, class) memberships), matching
    mmdet3d `CBGSDataset._get_sample_indices`. Deterministic per seed.

    mmdet3d emits the draws in raw `rng.choice` order — fine for its
    single-frame detectors, but this model streams sequences: the group
    samplers walk each group's frames in array order, so scrambled or
    interleaved duplicates would corrupt the temporal state. The draw
    multiset is therefore reorganised into temporally-ordered ROUNDS
    per original sequence (round r = the frames drawn more than r
    times, in timestamp order), each round under a fresh group id — a
    duplicated frame becomes an extra coherent (sub-)sequence pass,
    indistinguishable from the stream sampler's own `skip_prob`
    subsequences.
    """

    def __init__(self, dataset, seed: int = 0):
        num_cls = len(dataset.CLASSES)
        class_sample_idxs = {c: [] for c in range(num_cls)}
        for i in range(len(dataset)):
            for c in _sample_cat_ids(dataset, i):
                class_sample_idxs[c].append(i)
        total = sum(len(v) for v in class_sample_idxs.values())
        rng = np.random.default_rng(seed)
        draws: List[int] = []
        frac = 1.0 / num_cls
        for c, idxs in class_sample_idxs.items():
            if not idxs:
                continue
            ratio = frac / (len(idxs) / total)
            take = int(len(idxs) * ratio)
            draws.extend(
                rng.choice(np.asarray(idxs, np.int64), take).tolist()
            )
        counts = {}
        for i in draws:
            counts[i] = counts.get(i, 0) + 1
        base_flag = np.asarray(dataset.flag, np.int64)
        ordered: List[int] = []
        flags: List[int] = []
        next_flag = 0
        for g in np.unique(base_flag):
            members = np.where(base_flag == g)[0]  # temporal order
            r = 0
            while True:
                rnd = [int(i) for i in members if counts.get(int(i), 0) > r]
                if not rnd:
                    break
                ordered.extend(rnd)
                flags.extend([next_flag] * len(rnd))
                next_flag += 1
                r += 1
        super().__init__(
            dataset,
            np.asarray(ordered, np.int64),
            np.asarray(flags, np.int64),
        )
