"""NuScenes multi-view dataset and fixed-shape batch assembly (port of
`simpb_tpu/data/dataset.py`).

Consumes the `simpb_nuscenes_infos_{train,val}.pkl` files of the offline
converter and builds per-frame camera geometry, sequence grouping, the
image augmentation (drawn per sequence in training, fixed in test mode),
the network input, the 3D and per-camera 2D ground truth, the LiDAR
depth maps, and pads a training sample to the static shapes of the train
step (`pad_sample`). Samples are numpy; the evaluation loop and the
training CLI move them to the model's device. Temporal metadata
(`timestamp`, `lidar2global`) stays on the host, so unix-epoch
arithmetic never reaches the device.

The image route. The native C++ pass (`data/native_preprocess.py`) does
resize + crop + flip in one pass over the output pixels whenever it
builds and the augmentation does not rotate; otherwise PIL does
(`transforms.img_transform`). In test mode the native pass also
normalises, as in the JAX package. In training it runs with mean 0 and
std 1, so that the photometric jitter and the normalisation follow in
the JAX package's order (its training samples always take PIL; the
native pass also serves a host without Pillow). The draws on the
caller's generator are the same on both routes. `route_counts`
counts the samples each route took.
"""
from __future__ import annotations

import math
import os
import pickle
import threading
from typing import Dict, List, Optional

import numpy as np

from ..configs.base import CLASS_NAMES
from . import transforms as T

# the native pass's mean and std in training: resize + crop + flip alone
_ZERO = np.zeros(3, np.float32)
_ONE = np.ones(3, np.float32)

try:
    from pyquaternion import Quaternion
except ImportError:  # pragma: no cover
    Quaternion = None


def quat_to_mat(q) -> np.ndarray:
    """Quaternion [w, x, y, z] -> 3x3 rotation matrix."""
    if Quaternion is not None:
        return Quaternion(q).rotation_matrix
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class NuScenesDataset:
    CLASSES = CLASS_NAMES

    def __init__(
        self,
        ann_file: str,
        data_root: str = "",
        test_mode: bool = False,
        data_aug_conf: Optional[Dict] = None,
        sequences_split_num: int = 2,
        with_info2d: bool = True,
        strides=(4, 8, 16),
        load_interval: int = 1,
        use_valid_flag: bool = True,
        use_native: bool = True,
        draft_decode: bool = False,
    ):
        self.data_root = data_root
        self.test_mode = test_mode
        self.data_aug_conf = data_aug_conf
        self.with_info2d = with_info2d
        self.strides = strides
        self.use_valid_flag = use_valid_flag
        self.use_native = use_native
        # DCT-domain scaled JPEG decode (PIL `draft`): decode directly at
        # the smallest libjpeg n/8 scale that still covers the resize
        # factor. Opt-in: its downscale filter chain differs slightly from
        # a full-resolution bilinear resize.
        self.draft_decode = draft_decode
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        self.data_infos = sorted(data["infos"], key=lambda e: e["timestamp"])
        self.data_infos = self.data_infos[::load_interval]
        self.metadata = data.get("metadata", {})
        self.flag = self._sequence_flags(sequences_split_num)
        self.route_counts = {"native": 0, "pil": 0}

    def __len__(self):
        return len(self.data_infos)

    # ---------------- sequences ----------------
    def _sequence_flags(self, split_num: int) -> np.ndarray:
        """Group frames into (sub-)sequences
        (reference nuscenes_dataset.py:140-191)."""
        flags = []
        cur = 0
        for i, info in enumerate(self.data_infos):
            if i != 0 and len(info.get("sweeps", [])) == 0:
                cur += 1
            flags.append(cur)
        flags = np.asarray(flags, np.int64)
        if split_num == 1:
            return flags
        counts = np.bincount(flags)
        new_flags = []
        new_flag = 0
        for c in counts:
            bounds = list(range(0, c, math.ceil(c / split_num))) + [c]
            for length in np.diff(bounds):
                new_flags.extend([new_flag] * length)
                new_flag += 1
        return np.asarray(new_flags, np.int64)

    # ---------------- augmentation ----------------
    def get_augmentation(self, rng: Optional[np.random.Generator] = None):
        """Sample (train) or fix (eval) the image augmentation
        (reference nuscenes_dataset.py:193-241)."""
        if self.data_aug_conf is None:
            return None
        conf = self.data_aug_conf
        h, w = conf["H"], conf["W"]
        fh, fw = conf["final_dim"]
        if not self.test_mode and rng is not None:
            resize = rng.uniform(*conf["resize_lim"])
            new_w, new_h = int(w * resize), int(h * resize)
            crop_h = int((1 - rng.uniform(*conf["bot_pct_lim"])) * new_h) - fh
            crop_w = int(rng.uniform(0, max(0, new_w - fw)))
            crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
            flip = bool(conf["rand_flip"] and rng.integers(2))
            rotate = float(rng.uniform(*conf["rot_lim"]))
            rotate_3d = float(rng.uniform(*conf["rot3d_range"]))
            # draw only when configured: an unconditional draw would
            # shift the shared seeded rng stream for every existing
            # config (reproducibility of prior runs)
            scale_3d = (
                float(rng.uniform(*conf["scale_ratio_range"]))
                if "scale_ratio_range" in conf
                else 1.0
            )
        else:
            resize = max(fh / h, fw / w)
            new_w, new_h = int(w * resize), int(h * resize)
            crop_h = int((1 - np.mean(conf["bot_pct_lim"])) * new_h) - fh
            crop_w = int(max(0, new_w - fw) / 2)
            crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
            flip, rotate, rotate_3d, scale_3d = False, 0.0, 0.0, 1.0
        return {
            "resize": resize,
            "crop": crop,
            "flip": flip,
            "rotate": rotate,
            "rotate_3d": rotate_3d,
            "scale_3d": scale_3d,
            "final_dim": (fh, fw),
        }

    # ---------------- geometry ----------------
    def frame_geometry(self, info: Dict) -> Dict:
        """Per-frame poses + camera matrices
        (reference nuscenes_dataset.py:313-365)."""
        lidar2ego = np.eye(4)
        lidar2ego[:3, :3] = quat_to_mat(info["lidar2ego_rotation"])
        lidar2ego[:3, 3] = info["lidar2ego_translation"]
        ego2global = np.eye(4)
        ego2global[:3, :3] = quat_to_mat(info["ego2global_rotation"])
        ego2global[:3, 3] = info["ego2global_translation"]
        lidar2global = ego2global @ lidar2ego

        paths, intrinsics, extrinsics, cam_intrinsic = [], [], [], []
        for cam_info in info["cams"].values():
            paths.append(cam_info["data_path"])
            r = np.linalg.inv(cam_info["sensor2lidar_rotation"])
            t = cam_info["sensor2lidar_translation"] @ r.T
            l2c = np.eye(4)
            l2c[:3, :3] = r.T
            l2c[3, :3] = -t
            K = np.eye(4)
            K[:3, :3] = cam_info["cam_intrinsic"]
            cam_intrinsic.append(np.array(cam_info["cam_intrinsic"]))
            intrinsics.append(K)
            extrinsics.append(l2c.T)
        return {
            "timestamp": info["timestamp"] / 1e6,
            "lidar2global": lidar2global,
            "ego2global": ego2global,
            "img_paths": paths,
            "intrinsics": intrinsics,
            "extrinsics": extrinsics,
            "cam_intrinsic": cam_intrinsic,
            "lidar_path": info.get("lidar_path"),
        }

    # ---------------- sample assembly ----------------
    _decode_pool = None  # shared across instances (lazy, GIL-friendly)
    _decode_pool_lock = threading.Lock()

    def load_images(
        self, paths: List[str], dtype=np.float32,
        scale_hint: Optional[float] = None,
    ) -> List[np.ndarray]:
        """Decode the six camera images, in parallel on multi-core hosts
        (PIL's decoder releases the GIL). `dtype=np.uint8` feeds the
        native preprocessing pass without a float round-trip (>8-bit
        sources saturate rather than wrap).

        `scale_hint` (the resize factor) enables libjpeg DCT-domain
        scaled decode via PIL `draft`: the image decodes at the smallest
        n/8 scale >= the hint, taken only when that scale divides both
        dimensions exactly (so one resize factor stays exact on both
        axes); otherwise the full-resolution decode runs. The caller
        rescales its resize factor by (src_w / decoded_w)."""
        from PIL import Image

        def _one(p):
            im = Image.open(p)
            if scale_hint is not None and im.format == "JPEG":
                w0, h0 = im.size
                im.draft(
                    "RGB",
                    (max(1, int(np.ceil(w0 * scale_hint))),
                     max(1, int(np.ceil(h0 * scale_hint)))),
                )
                wd, hd = im.size
                aspect_exact = (
                    (h0 * wd) % w0 == 0 and hd == h0 * wd // w0
                )
                if (wd, hd) != (w0, h0) and not aspect_exact:
                    im = Image.open(p)  # uneven n/8 rounding: full res
            arr = np.asarray(im)
            if dtype == np.uint8 and arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255)  # 16-bit sources: saturate
            return arr.astype(dtype, copy=False)

        if os.cpu_count() == 1 or len(paths) == 1:
            return [_one(p) for p in paths]
        if NuScenesDataset._decode_pool is None:
            with NuScenesDataset._decode_pool_lock:
                if NuScenesDataset._decode_pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    NuScenesDataset._decode_pool = ThreadPoolExecutor(
                        max_workers=min(6, os.cpu_count())
                    )
        return list(NuScenesDataset._decode_pool.map(_one, paths))

    def get_sample(
        self,
        idx: int,
        aug: Optional[Dict] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> Dict:
        """One frame's raw (un-padded) sample dict: `img` [cams, H, W, 3]
        float32 (normalised), `projection_mat` [cams, 4, 4] float32,
        `focal`, `timestamp` (s), `lidar2global`, `ego2global`, the
        camera matrices and `aug_config`; in training also the 3D and 2D
        ground truth and, with a LiDAR file, `gt_depth`.
        `aug` defaults to `get_augmentation(rng)`; `rng` also draws the
        photometric jitter in training."""
        info = self.data_infos[idx]
        geo = self.frame_geometry(info)
        if aug is None:
            aug = self.get_augmentation(rng)

        # decide the image route BEFORE decoding so the native pass can
        # take uint8 straight from the decoder
        use_native_path = self.use_native and not aug.get("rotate")
        if use_native_path:
            from . import native_preprocess as npz

            use_native_path = npz.available()
        self.route_counts["native" if use_native_path else "pil"] += 1
        imgs = self.load_images(
            geo["img_paths"],
            dtype=np.uint8 if use_native_path else np.float32,
            scale_hint=(
                aug.get("resize", 1.0)
                if use_native_path and self.draft_decode
                else None
            ),
        )
        sample = {
            "timestamp": geo["timestamp"],
            "lidar2global": geo["lidar2global"],
            "ego2global": geo["ego2global"],
            "intrinsics": list(geo["intrinsics"]),
            "extrinsics": list(geo["extrinsics"]),
            "cam_intrinsic": list(geo["cam_intrinsic"]),
        }

        # annotations
        if not self.test_mode:
            self._add_annotations(sample, info, geo)

        # image aug + intrinsic updates (the native fused pass, or PIL)
        new_imgs = []
        for i, img in enumerate(imgs):
            if use_native_path:
                from . import native_preprocess as npz

                # draft-decoded sources arrive pre-scaled by k; the pass's
                # source mapping composes exactly through resize * k, and
                # the intrinsic update below keeps the original resize
                # (final geometry unchanged). Without draft decode the
                # image is full size and the resize applies as it is.
                if self.draft_decode:
                    src_w = (self.data_aug_conf or {}).get(
                        "W", img.shape[1]
                    )
                    k = src_w / img.shape[1]
                else:
                    k = 1.0
                aug_i = (
                    dict(aug, resize=aug.get("resize", 1.0) * k)
                    if k != 1.0
                    else aug
                )
                if self.test_mode:  # the pass normalises itself
                    out = npz.preprocess_image(img, aug_i)
                else:  # resize + crop + flip alone; jitter comes next
                    out = npz.preprocess_image(img, aug_i, mean=_ZERO,
                                               std=_ONE)
                # intrinsic update matrix (same math as img_transform)
                m = np.eye(3)
                m[:2, :2] *= aug.get("resize", 1.0)
                m[:2, 2] -= np.array(aug["crop"][:2])
                if aug.get("flip"):
                    fw_ = aug["crop"][2] - aug["crop"][0]
                    m = np.array([[-1, 0, fw_], [0, 1, 0], [0, 0, 1]]) @ m
                ext = np.eye(4)
                ext[:3, :3] = m
                sample["intrinsics"][i] = ext @ sample["intrinsics"][i]
                new_imgs.append(out)
                continue
            img, mat = T.img_transform(img, aug)
            sample["intrinsics"][i] = mat @ sample["intrinsics"][i]
            new_imgs.append(img)
        if not self.test_mode and "gt_bboxes_2d" in sample:
            self._transform_gt2d(sample, aug)
        sample["lidar2img"] = [
            sample["intrinsics"][i] @ sample["extrinsics"][i]
            for i in range(len(imgs))
        ]

        # lidar depth supervision
        if not self.test_mode and geo["lidar_path"]:
            try:
                pts = np.fromfile(geo["lidar_path"], np.float32).reshape(-1, 5)
                fh, fw = aug["final_dim"]
                sample["gt_depth"] = T.depth_maps_from_points(
                    pts, sample["lidar2img"], (fh, fw), self.strides
                )
            except (FileNotFoundError, OSError):
                pass

        # 3D rotation and scale (identity unless the augmentation sets
        # them)
        if not self.test_mode and aug.get("rotate_3d"):
            T.rotate_3d(sample, aug["rotate_3d"])
        if not self.test_mode and aug.get("scale_3d", 1.0) != 1.0:
            T.scale_3d(sample, aug["scale_3d"])

        if not self.test_mode and rng is not None:
            new_imgs = T.photometric_distortion(rng, new_imgs)
        if not (use_native_path and self.test_mode):
            new_imgs = T.normalize_images(new_imgs)

        # range + class filters (reference CircleObjectRangeFilter)
        if not self.test_mode and "gt_bboxes_3d" in sample:
            keep = T.circle_range_filter(
                sample["gt_bboxes_3d"], sample["gt_labels_3d"]
            )
            keep &= sample["gt_labels_3d"] >= 0
            self._filter_3d(sample, keep)
            sample["gt_bboxes_3d"][:, 6] = T.limit_period(
                sample["gt_bboxes_3d"][:, 6]
            )

        sample["img"] = np.stack(new_imgs)  # [cams, H, W, 3]
        sample["projection_mat"] = np.stack(sample["lidar2img"]).astype(
            np.float32
        )
        sample["focal"] = np.stack(
            [k[0, 0] for k in sample["cam_intrinsic"]]
        ).astype(np.float32)
        sample["aug_config"] = aug
        return sample

    def get_annotations(self, idx: int) -> Dict:
        """3D GT only (lidar frame), no image pipeline — for evaluation."""
        info = self.data_infos[idx]
        geo = self.frame_geometry(info)
        sample: Dict = {"lidar2global": geo["lidar2global"]}
        saved = self.with_info2d
        self.with_info2d = False
        try:
            self._add_annotations(sample, info, geo)
        finally:
            self.with_info2d = saved
        return sample

    def _add_annotations(self, sample, info, geo):
        """3D + 2D GT assembly (reference get_ann_info,
        nuscenes_dataset.py:427-502)."""
        mask = (
            info["valid_flag"]
            if self.use_valid_flag and "valid_flag" in info
            else info["num_lidar_pts"] > 0
        )
        boxes = info["gt_boxes"][mask]
        names = info["gt_names"][mask]
        labels = np.array(
            [
                self.CLASSES.index(n) if n in self.CLASSES else -1
                for n in names
            ],
            np.int64,
        )
        vel = info.get("gt_velocity")
        if vel is not None:
            vel = np.nan_to_num(vel[mask])
            boxes = np.concatenate([boxes, vel], axis=-1)
        sample["gt_bboxes_3d"] = boxes.astype(np.float32)
        sample["gt_labels_3d"] = labels
        if "instance_inds" in info:
            sample["gt_instance_id"] = np.asarray(
                info["instance_inds"], np.int64
            )[mask]

        if self.with_info2d and "bboxes2d" in info:
            alphas = self._alphas(info["gt_boxes"], geo["extrinsics"])
            # remap 2D GT through the 3D validity mask
            remap = -np.ones(len(mask) + 1, np.int64)
            remap[: len(mask)][mask] = np.arange(mask.sum())
            g2d, l2d, c2d, d2d, m2d, a2d = [], [], [], [], [], []
            for cam in range(len(geo["img_paths"])):
                mapping = np.asarray(info["gt_2d_3d_map"][cam], np.int64)
                keep = np.ones(len(mapping), bool)
                for j, m3d in enumerate(mapping):
                    if 0 <= m3d < len(mask) and not mask[m3d]:
                        keep[j] = False
                g2d.append(np.asarray(info["bboxes2d"][cam])[keep])
                l2d.append(np.asarray(info["labels2d"][cam])[keep])
                c2d.append(np.asarray(info["centers2d"][cam])[keep])
                d2d.append(np.asarray(info["depths"][cam])[keep])
                # NB: mapping == -1 (2D GT without a 3D parent) python-
                # wraps to the LAST 3D box's alpha — the reference does
                # the identical wrap (nuscenes_dataset.py:472
                # `gt_alphas_2d[cam_idx][map_2d_3d]`); kept for parity
                a2d.append(alphas[cam][mapping][keep])
                m2d.append(remap[mapping[keep]])
            sample.update(
                gt_bboxes_2d=g2d, gt_labels_2d=l2d, gt_centers_2d=c2d,
                gt_depths_2d=d2d, gt_2d_3d_map=m2d, gt_alphas_2d=a2d,
            )

    @staticmethod
    def _alphas(boxes3d, extrinsics):
        """Per-camera observation angles (reference get_alphas,
        nuscenes_dataset.py:388-425)."""
        axis = np.array(
            [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
            np.float64,
        )
        out = []
        for ext in extrinsics:
            centers = np.concatenate(
                [boxes3d[:, :3], np.ones((len(boxes3d), 1))], -1
            )
            cam = ext @ centers.T
            alphas = np.zeros(len(boxes3d), np.float32)
            valid = cam[2] > 0.2
            for i in np.where(valid)[0]:
                yaw = boxes3d[i][6]
                rot = np.array(
                    [
                        [np.cos(yaw), -np.sin(yaw), 0, 0],
                        [np.sin(yaw), np.cos(yaw), 0, 0],
                        [0, 0, 1, 0],
                        [0, 0, 0, 1],
                    ]
                )
                m = (np.linalg.inv(axis) @ ext) @ rot
                sy = math.hypot(m[0][0], m[1][0])
                ry = -(
                    math.atan2(m[1][0], m[0][0]) if sy > 1e-6 else 0.0
                )
                x, z = cam[0, i], cam[2, i]
                beta = np.arctan(z / x) if x != 0 else np.pi / 2
                if beta < 0:
                    beta += np.pi
                beta -= np.pi / 2
                a = ry + beta
                if a < -np.pi:
                    a += 2 * np.pi
                if a > np.pi:
                    a -= 2 * np.pi
                alphas[i] = a
            out.append(alphas)
        return out

    def _transform_gt2d(self, sample, aug):
        fh, fw = aug["final_dim"]
        for cam in range(len(sample["gt_bboxes_2d"])):
            b = np.asarray(sample["gt_bboxes_2d"][cam], np.float32).reshape(
                -1, 4
            )
            c = np.asarray(sample["gt_centers_2d"][cam], np.float32).reshape(
                -1, 2
            )
            a = np.asarray(sample["gt_alphas_2d"][cam], np.float32).reshape(-1)
            if len(b) == 0:
                continue
            b, c, a, keep = T.transform_boxes2d(b, c, a, aug)
            d = np.asarray(sample["gt_depths_2d"][cam])[keep]
            m = np.asarray(sample["gt_2d_3d_map"][cam])[keep]
            l = np.asarray(sample["gt_labels_2d"][cam])[keep]
            b, c, a = b[keep], c[keep], a[keep]
            vis = T.filter_occluded(b, d, fh, fw)
            sample["gt_bboxes_2d"][cam] = b[vis]
            sample["gt_centers_2d"][cam] = c[vis]
            sample["gt_alphas_2d"][cam] = a[vis]
            sample["gt_depths_2d"][cam] = d[vis]
            sample["gt_2d_3d_map"][cam] = m[vis]
            sample["gt_labels_2d"][cam] = l[vis]

    def _filter_3d(self, sample, keep):
        remap = -np.ones(len(keep) + 1, np.int64)
        remap[: len(keep)][keep] = np.arange(keep.sum())
        sample["gt_bboxes_3d"] = sample["gt_bboxes_3d"][keep]
        sample["gt_labels_3d"] = sample["gt_labels_3d"][keep]
        if "gt_instance_id" in sample:
            sample["gt_instance_id"] = sample["gt_instance_id"][keep]
        if "gt_2d_3d_map" in sample:
            for cam in range(len(sample["gt_2d_3d_map"])):
                mapping = np.asarray(sample["gt_2d_3d_map"][cam], np.int64)
                keep2d = (mapping < 0) | keep[np.clip(mapping, 0, len(keep) - 1)]
                for key in [
                    "gt_bboxes_2d", "gt_labels_2d", "gt_centers_2d",
                    "gt_depths_2d", "gt_alphas_2d",
                ]:
                    sample[key][cam] = np.asarray(sample[key][cam])[keep2d]
                sample["gt_2d_3d_map"][cam] = remap[mapping[keep2d]]


def pad_sample(
    sample: Dict,
    max_gt3d: int = 128,
    max_gt2d: int = 64,
    num_cams: int = 6,
) -> Dict:
    """Raw sample -> fixed-shape arrays matching the train-step batch
    contract (`training/train_step.py`; `tools/train.py::make_batch`
    stacks a batch of them)."""
    out = {
        "img": sample["img"].astype(np.float32),
        "projection_mat": sample["projection_mat"].astype(np.float32),
        "focal": sample["focal"].astype(np.float32),
    }
    if "gt_bboxes_3d" in sample:
        g = len(sample["gt_bboxes_3d"])
        gk = min(g, max_gt3d)
        boxes = np.zeros((max_gt3d, 9), np.float32)
        labels = np.full((max_gt3d,), -1, np.int32)
        valid = np.zeros((max_gt3d,), bool)
        iid = np.full((max_gt3d,), -1, np.int32)
        if gk:
            b = sample["gt_bboxes_3d"][:gk]
            boxes[:gk, : b.shape[-1]] = b
            labels[:gk] = sample["gt_labels_3d"][:gk]
            valid[:gk] = True
            if "gt_instance_id" in sample:
                iid[:gk] = sample["gt_instance_id"][:gk]
        out.update(
            gt_boxes3d=boxes, gt_labels3d=labels, gt_valid3d=valid,
            gt_instance_id=iid,
        )
    if "gt_bboxes_2d" in sample:
        b2 = np.zeros((num_cams, max_gt2d, 4), np.float32)
        l2 = np.full((num_cams, max_gt2d), -1, np.int32)
        a2 = np.zeros((num_cams, max_gt2d), np.float32)
        v2 = np.zeros((num_cams, max_gt2d), bool)
        # per-3D-GT scattered 2D targets for DN (reference
        # target.py:619-636 does this scatter on device; here on host)
        vis_p3 = np.zeros((max_gt3d, num_cams), bool)
        b_p3 = np.zeros((max_gt3d, num_cams, 4), np.float32)
        l_p3 = np.full((max_gt3d, num_cams), -1, np.int32)
        a_p3 = np.zeros((max_gt3d, num_cams), np.float32)
        for cam in range(num_cams):
            bb = np.asarray(sample["gt_bboxes_2d"][cam], np.float32).reshape(
                -1, 4
            )
            n = min(len(bb), max_gt2d)
            if n:
                b2[cam, :n] = bb[:n]
                l2[cam, :n] = sample["gt_labels_2d"][cam][:n]
                a2[cam, :n] = sample["gt_alphas_2d"][cam][:n]
                v2[cam, :n] = True
            mapping = np.asarray(sample["gt_2d_3d_map"][cam], np.int64)
            for j, m3d in enumerate(mapping):
                if 0 <= m3d < max_gt3d and j < len(bb):
                    vis_p3[m3d, cam] = True
                    b_p3[m3d, cam] = bb[j]
                    l_p3[m3d, cam] = sample["gt_labels_2d"][cam][j]
                    a_p3[m3d, cam] = sample["gt_alphas_2d"][cam][j]
        out.update(
            gt_boxes2d=b2, gt_labels2d=l2, gt_alphas2d=a2, gt_valid2d=v2,
            gt_vis2d_per3d=vis_p3, gt_boxes2d_per3d=b_p3,
            gt_labels2d_per3d=l_p3, gt_alphas2d_per3d=a_p3,
        )
    if "gt_depth" in sample:
        out["gt_depth"] = [d.astype(np.float32) for d in sample["gt_depth"]]
    return out
