"""The port's training data pipeline against the JAX package's, on the CPU
at small sizes, bit for bit (`np.array_equal`, same dtypes).

Held to JAX on the same numpy-seeded inputs and the same generator
draws: each training transform of `data/transforms.py` (the photometric
distortion over one generator, so its draws must come in JAX's order);
`get_augmentation(rng)`; `get_sample` in training mode and `pad_sample`
on every field, on the PIL route against JAX's
`NuScenesDataset(test_mode=False)` over a fake nuScenes-format pkl with
PNG images, 2D GT (a 2D box without a 3D parent among them) and LiDAR
files; the native route against JAX's own composition of its native
pass (mean 0, std 1), `photometric_distortion` and `normalize_images`;
`GroupStreamSampler` over enough iterations that slots start new
sequences and skip frames, and `group_epoch_indices`; and the training
CLI's `make_batch` stream (`time_interval`, `temp2cur`, every padded
key, `gt_depth`) against the same stream composed from JAX's sampler,
dataset and `pad_sample`, with the JAX CLI's `make_batch` arithmetic
(a closure in its `tools/train.py`) written out here. Nothing here
compiles a JAX model: the JAX data modules are numpy.
"""
import copy

import numpy as np
import pytest
import torch

from simpb_tpu.data import native_preprocess as jax_native
from simpb_tpu.data import sampler as jax_sampler
from simpb_tpu.data import transforms as JT
from simpb_tpu.data.dataset import NuScenesDataset as JaxDataset
from simpb_tpu.data.dataset import pad_sample as jax_pad
from simpb_tpu_torch.data import native_preprocess
from simpb_tpu_torch.data import sampler
from simpb_tpu_torch.data import transforms as T
from simpb_tpu_torch.data.dataset import NuScenesDataset, pad_sample
from simpb_tpu_torch.tools import train as train_cli
from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

SRC_H, SRC_W = 80, 160  # the CLI's 0.40-0.47 resize covers 64x32
N_FRAMES = 12


def _cfg():
    return train_cli.build_config(train_cli.parse_args(
        ["--ann-file", "x", "--config", "tiny"]))


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("fake_train")
    pkl = write_synthetic_infos(str(d), n_frames=N_FRAMES, gap_at=(6,),
                                src_hw=(SRC_H, SRC_W), num_objects=8,
                                write_images=True, with_2d=True,
                                with_lidar=True)
    cfg = _cfg()
    aug = train_cli.train_aug_conf(cfg, SRC_H, SRC_W)
    kw = dict(test_mode=False, data_aug_conf=aug, sequences_split_num=2,
              strides=cfg.strides[: cfg.num_depth_layers])
    return pkl, aug, kw, cfg


def assert_same(got, want, path="sample"):
    """`got` equals `want` bit for bit: the same keys, lengths, dtypes,
    shapes and values, recursively."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, (
            path, got.dtype, got.shape, want.dtype, want.shape)
        assert np.array_equal(got, want, equal_nan=True), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _boxes(rng, n):
    x0 = rng.uniform(-20, 120, n)
    y0 = rng.uniform(-20, 60, n)
    return np.stack([x0, y0, x0 + rng.uniform(0, 60, n),
                     y0 + rng.uniform(0, 30, n)], -1).astype(np.float32)


def _case(name, rng):
    """(port function, JAX function, args) of one transform."""
    aug = dict(resize=0.44, crop=(5, 3, 69, 35), flip=True,
               final_dim=(32, 64))
    if name == "transform_boxes2d":
        return (T.transform_boxes2d, JT.transform_boxes2d,
                lambda: (_boxes(rng, 40),
                         rng.uniform(-10, 150, (40, 2)).astype(np.float32),
                         rng.uniform(-4, 4, 40).astype(np.float32),
                         dict(aug)))
    if name == "filter_occluded":
        b = _boxes(np.random.default_rng(1), 30)
        b[:, (0, 2)] = np.clip(b[:, (0, 2)], 0, 64)
        b[:, (1, 3)] = np.clip(b[:, (1, 3)], 0, 32)
        return (T.filter_occluded, JT.filter_occluded,
                lambda: (b, rng.uniform(1, 50, 30), 32, 64))
    if name == "hsv_round_trip":
        img = rng.uniform(-40, 300, (7, 9, 3)).astype(np.float32)
        img[0, 0] = img[0, 0, 0]  # grey: v == r == g == b
        return (lambda x: T.hsv_to_rgb(T.rgb_to_hsv(x)),
                lambda x: JT.hsv_to_rgb(JT.rgb_to_hsv(x)), lambda: (img,))
    if name == "photometric_distortion":
        imgs = [rng.uniform(0, 255, (6, 10, 3)).astype(np.float32)
                for _ in range(12)]

        def run(fn):
            def call(seed):
                g = np.random.default_rng(seed)
                out = fn(g, [x.copy() for x in imgs])
                return out, g.integers(1 << 30)  # the generator's state
            return call
        return (run(T.photometric_distortion),
                run(JT.photometric_distortion), lambda: (7,))
    if name in ("rotate_3d", "scale_3d"):
        sample = dict(
            lidar2img=[rng.normal(size=(4, 4)) for _ in range(6)],
            extrinsics=[rng.normal(size=(4, 4)) for _ in range(6)],
            lidar2global=rng.normal(size=(4, 4)),
            gt_bboxes_3d=rng.normal(size=(9, 9)).astype(np.float32))
        value = 0.31 if name == "rotate_3d" else 1.07
        return (getattr(T, name), getattr(JT, name),
                lambda: (copy.deepcopy(sample), value))
    if name == "depth_maps_from_points":
        pts = np.concatenate([rng.uniform(-30, 30, (500, 3)),
                              rng.uniform(0, 1, (500, 2))], 1)
        proj = [m.astype(np.float64) for m in _rig()]
        return (T.depth_maps_from_points, JT.depth_maps_from_points,
                lambda: (pts.astype(np.float32), proj, (32, 64), (4, 8, 16)))
    if name == "limit_period":
        return (T.limit_period, JT.limit_period,
                lambda: (rng.uniform(-20, 20, 50),))
    if name == "circle_range_filter":
        return (T.circle_range_filter, JT.circle_range_filter,
                lambda: (rng.uniform(-70, 70, (50, 9)),
                         rng.integers(-1, 10, 50)))
    raise KeyError(name)


def _rig():
    from simpb_tpu_torch.utils.synthetic import synthetic_rig

    return list(synthetic_rig(1, (64, 32))[0])


TRANSFORMS = ["transform_boxes2d", "filter_occluded", "hsv_round_trip",
              "photometric_distortion", "rotate_3d", "scale_3d",
              "depth_maps_from_points", "limit_period",
              "circle_range_filter"]


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_jax(name):
    port, ref, args = _case(name, np.random.default_rng(3))
    a = args()
    b = copy.deepcopy(a)
    assert_same(port(*a), ref(*b), name)
    assert_same(a, b, f"{name} inputs")  # the same in-place effects


def test_skip_photometric_makes_the_same_draws():
    imgs = [np.full((2, 3, 3), 100.0, np.float32)] * 5
    g1, g2 = np.random.default_rng(4), np.random.default_rng(4)
    T.photometric_distortion(g1, imgs)
    T.skip_photometric(g2, len(imgs))
    assert g1.integers(1 << 40) == g2.integers(1 << 40)


@pytest.mark.parametrize("scale", [False, True], ids=["conf", "scale3d"])
def test_get_augmentation_matches_jax(train_set, scale):
    pkl, aug, kw, _ = train_set
    if scale:
        aug = dict(aug, scale_ratio_range=(0.95, 1.05))
    kw = dict(kw, data_aug_conf=aug)
    jds, tds = JaxDataset(pkl, **kw), NuScenesDataset(pkl, **kw)
    g1, g2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(8):
        assert_same(tds.get_augmentation(g2), jds.get_augmentation(g1))
    assert g1.integers(1 << 40) == g2.integers(1 << 40)
    # no generator: the fixed test-mode augmentation
    assert_same(tds.get_augmentation(), jds.get_augmentation())


def test_get_sample_and_pad_match_jax_on_the_pil_route(train_set):
    pkl, _, kw, cfg = train_set
    jds = JaxDataset(pkl, **kw)
    tds = NuScenesDataset(pkl, use_native=False, **kw)
    g1, g2 = np.random.default_rng(6), np.random.default_rng(6)
    orphans = 0
    for idx in range(N_FRAMES):
        aug1, aug2 = jds.get_augmentation(g1), tds.get_augmentation(g2)
        j = jds.get_sample(idx, aug=aug1, rng=g1)
        t = tds.get_sample(idx, aug=aug2, rng=g2)
        assert_same(t, j, f"frame {idx}")
        assert t["gt_depth"][0].shape == (6, 8, 16)
        orphans += sum(int((m < 0).sum()) for m in t["gt_2d_3d_map"])
        for gt3d, gt2d in ((8, 4), (32, 8)):  # truncating and not
            assert_same(pad_sample(t, max_gt3d=gt3d, max_gt2d=gt2d),
                        jax_pad(j, max_gt3d=gt3d, max_gt2d=gt2d),
                        f"padded frame {idx}")
    assert orphans > 0  # the mapping == -1 wrap was exercised
    assert tds.route_counts == {"native": 0, "pil": N_FRAMES}


def test_native_route_matches_jax_composition(train_set):
    """The port's training native route: its pass with mean 0 and std 1
    (resize + crop + flip), the photometric jitter, then the
    normalisation; against the JAX package's native pass, photometric
    distortion and normalisation composed the same way."""
    pkl, _, kw, _ = train_set
    assert native_preprocess.available()
    jds = JaxDataset(pkl, **kw)
    tds = NuScenesDataset(pkl, **kw)
    zero, one = np.zeros(3, np.float32), np.ones(3, np.float32)
    g1, g2 = np.random.default_rng(7), np.random.default_rng(7)
    for idx in range(N_FRAMES):
        aug1, aug2 = jds.get_augmentation(g1), tds.get_augmentation(g2)
        t = tds.get_sample(idx, aug=aug2, rng=g2)
        paths = jds.frame_geometry(jds.data_infos[idx])["img_paths"]
        imgs = [jax_native.preprocess_image(im, aug1, mean=zero, std=one)
                for im in jds.load_images(paths, dtype=np.uint8)]
        want = np.stack(JT.normalize_images(
            JT.photometric_distortion(g1, imgs)))
        assert_same(t["img"], want, f"frame {idx}")
        # the rest of the sample is the PIL route's
        j = jds.get_sample(idx, aug=aug1, rng=np.random.default_rng(0))
        for key in ("projection_mat", "gt_bboxes_3d", "gt_bboxes_2d",
                    "gt_2d_3d_map", "gt_depth"):
            assert_same(t[key], j[key], f"frame {idx} {key}")
    assert tds.route_counts == {"native": N_FRAMES, "pil": 0}


@pytest.mark.parametrize("bs,world,rank", [(2, 1, 0), (1, 2, 1), (3, 1, 0)])
def test_group_stream_sampler_matches_jax(train_set, bs, world, rank):
    pkl, _, kw, _ = train_set
    jds, tds = JaxDataset(pkl, **kw), NuScenesDataset(pkl, **kw)
    js = jax_sampler.GroupStreamSampler(jds, bs, world, rank, seed=9)
    ts = sampler.GroupStreamSampler(tds, bs, world, rank, seed=9)
    jit, tit = iter(js), iter(ts)
    new_seqs = 0
    for _ in range(24):
        jb, tb = next(jit), next(tit)
        assert_same(tb, jb)
        new_seqs += sum(n for _, _, n in tb)
    assert new_seqs >= 4
    assert js.rng.integers(1 << 40) == ts.rng.integers(1 << 40)


def test_group_stream_sampler_skips_frames(train_set):
    """Over a long stream some slot steps by two frames (skip_prob)."""
    pkl, _, kw, _ = train_set
    ts = sampler.GroupStreamSampler(NuScenesDataset(pkl, **kw), 1, seed=2)
    flags = NuScenesDataset(pkl, **kw).flag
    prev, jumps = None, 0
    for batch in (b for b, _ in zip(ts, range(40))):
        idx, _, new_seq = batch[0]
        if prev is not None and not new_seq and \
                flags[idx] == flags[prev] and abs(idx - prev) == 2:
            jumps += 1
        prev = idx
    assert jumps > 0


@pytest.mark.parametrize("spd,replicas,rank,epoch", [
    (2, 1, 0, 0), (3, 2, 1, 4), (1, 3, 2, 1)])
def test_group_epoch_indices_matches_jax(spd, replicas, rank, epoch):
    flags = np.repeat(np.arange(5), [7, 3, 9, 1, 4])
    assert_same(
        sampler.group_epoch_indices(flags, spd, replicas, rank, epoch, 11),
        jax_sampler.group_epoch_indices(flags, spd, replicas, rank, epoch,
                                        11))


def _jax_make_batch(dataset, items, rng, prev_pose, cfg):
    """The JAX CLI's `make_batch` (a closure in its tools/train.py),
    written out: JAX's get_sample and pad_sample, then its dt and
    temp2cur arithmetic."""
    raws = [dataset.get_sample(idx, aug=aug, rng=rng)
            for idx, aug, _ in items]
    samples = [jax_pad(s, max_gt3d=min(128, cfg.head.num_anchor),
                       max_gt2d=min(64, cfg.head.allocation_capacity))
               for s in raws]
    dts = np.zeros((len(raws),), np.float32)
    t2c = np.tile(np.eye(4, dtype=np.float32), (len(raws), 1, 1))
    for j, (raw, (_, _, new_seq)) in enumerate(zip(raws, items)):
        if new_seq or prev_pose[j] is None:
            dts[j] = 1e6
        else:
            pts, pT = prev_pose[j]
            dts[j] = raw["timestamp"] - pts
            t2c[j] = np.linalg.inv(raw["lidar2global"]) @ pT
        prev_pose[j] = (raw["timestamp"], raw["lidar2global"])
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]
             if k != "gt_depth"}
    batch["time_interval"] = dts
    batch["temp2cur"] = t2c
    if "gt_depth" in samples[0]:
        batch["gt_depth"] = [np.stack([s["gt_depth"][lvl] for s in samples])
                             for lvl in range(len(samples[0]["gt_depth"]))]
    return batch


def test_make_batch_stream_matches_jax(train_set):
    pkl, _, kw, cfg = train_set
    bs = 2
    jds = JaxDataset(pkl, **kw)
    tds = NuScenesDataset(pkl, use_native=False, **kw)
    jit = iter(jax_sampler.GroupStreamSampler(jds, bs, seed=0))
    tit = iter(sampler.GroupStreamSampler(tds, bs, seed=0))
    g1, g2 = np.random.default_rng(0), np.random.default_rng(0)
    jpose, tpose = [None] * bs, [None] * bs
    streamed = broken = 0
    for _ in range(10):
        want = _jax_make_batch(jds, next(jit), g1, jpose, cfg)
        got = train_cli.make_batch(tds, next(tit), g2, tpose, cfg)
        assert_same(got, want)
        assert_same(tpose, jpose, "prev_pose")
        streamed += int((got["time_interval"] < 1e6).sum())
        broken += int((got["time_interval"] == 1e6).sum())
    assert streamed > 0 and broken > 0
    assert got["img"].shape == (bs, 6, 32, 64, 3)
    assert got["gt_boxes3d"].shape == (bs, 32, 9)
    assert got["gt_boxes2d"].shape == (bs, 6, 8, 4)
    assert [d.shape[2:] for d in got["gt_depth"]] == [(8, 16), (4, 8),
                                                       (2, 4)]
