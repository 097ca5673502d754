"""NuScenes multi-view dataset, test mode (port of the evaluation side of
`simpb_tpu/data/dataset.py::NuScenesDataset`).

Consumes the `simpb_nuscenes_infos_{train,val}.pkl` files of the offline
converter and builds per-frame camera geometry, sequence grouping, the
fixed test-mode augmentation, the network input (the native C++ pass
when it builds, else PIL) and the 3D ground truth for scoring. Samples
are numpy; the evaluation loop moves them to the model's device.
Temporal metadata (`timestamp`, `lidar2global`) stays on the host, so
unix-epoch arithmetic never reaches the device.

Not ported yet (ROADMAP A.2): the training side — 2D ground truth,
random and photometric augmentation, 3D rotation and scale, the range
filter, depth maps and `pad_sample`. A dataset with `test_mode=False`
raises `NotImplementedError`.
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
        test_mode: bool = True,
        data_aug_conf: Optional[Dict] = None,
        sequences_split_num: int = 2,
        load_interval: int = 1,
        use_valid_flag: bool = True,
        use_native: bool = True,
        draft_decode: bool = False,
    ):
        if not test_mode:
            raise NotImplementedError(
                "training-mode samples (test_mode=False) are not ported "
                "yet (ROADMAP A.2)"
            )
        self.data_root = data_root
        self.test_mode = test_mode
        self.data_aug_conf = data_aug_conf
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
    def get_augmentation(self):
        """The fixed test-mode image augmentation (reference
        nuscenes_dataset.py:193-241, eval branch): resize to cover the
        final size, bottom crop at the mean of `bot_pct_lim`, centred
        horizontally; no flip or rotation."""
        if self.data_aug_conf is None:
            return None
        conf = self.data_aug_conf
        h, w = conf["H"], conf["W"]
        fh, fw = conf["final_dim"]
        resize = max(fh / h, fw / w)
        new_w, new_h = int(w * resize), int(h * resize)
        crop_h = int((1 - np.mean(conf["bot_pct_lim"])) * new_h) - fh
        crop_w = int(max(0, new_w - fw) / 2)
        crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
        return {
            "resize": resize,
            "crop": crop,
            "flip": False,
            "rotate": 0.0,
            "rotate_3d": 0.0,
            "scale_3d": 1.0,
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

    def get_sample(self, idx: int) -> Dict:
        """One frame's raw sample dict: `img` [cams, H, W, 3] float32
        (normalised), `projection_mat` [cams, 4, 4] float32, `focal`,
        `timestamp` (s), `lidar2global`, `ego2global`, the camera
        matrices and `aug_config`."""
        info = self.data_infos[idx]
        geo = self.frame_geometry(info)
        aug = self.get_augmentation()

        # decide the preprocessing path BEFORE decoding so the native
        # path can take uint8 straight from the decoder
        use_native_path = self.use_native and not aug.get("rotate")
        if use_native_path:
            from . import native_preprocess as npz

            use_native_path = npz.available()
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
                out = npz.preprocess_image(img, aug_i)
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
        sample["lidar2img"] = [
            sample["intrinsics"][i] @ sample["extrinsics"][i]
            for i in range(len(imgs))
        ]
        if not use_native_path:  # the native pass normalises itself
            new_imgs = T.normalize_images(new_imgs)

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
        """3D GT only (lidar frame), no image pipeline — for evaluation
        (reference get_ann_info, nuscenes_dataset.py:427-502, 3D part)."""
        info = self.data_infos[idx]
        geo = self.frame_geometry(info)
        sample: Dict = {"lidar2global": geo["lidar2global"]}
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
        return sample
