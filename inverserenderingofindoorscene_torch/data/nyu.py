"""NYU geometry pipeline (NHWC numpy).

The counterpart of the JAX package's ``data/nyu.py``; for the same files,
seed and epoch its outputs are bit-equal to the JAX loader's.

Reproduces the reference ``NYULoader`` (nyuDataLoader.py:27-173):
random crop of 560-600 px width (aspect-matched height) from the 480x640
frames, resize to (H, W), horizontal flip with normal-x negation,
per-channel color jitter +-20%, gamma 2.2 image to linear [0,1],
unit-normalized normals (re-normalized after resize), .tiff depth with the
1<d<10 validity mask.
"""

from __future__ import annotations

import os.path as osp

import numpy as np


class NYUDataset:
    def __init__(self, im_root, normal_root, depth_root, seg_root,
                 im_list_file, im_hw=(240, 320), crop_w=(560, 600),
                 phase="TRAIN", seed=None):
        with open(im_list_file) as f:
            names = [x.strip() for x in f if x.strip()]
        self.im_list = [osp.join(im_root, x) for x in names]
        self.normal_list = [x.replace(im_root, normal_root) for x in self.im_list]
        self.seg_list = [x.replace(im_root, seg_root) for x in self.im_list]
        self.depth_list = [
            x.replace(im_root, depth_root).replace(".png", ".tiff")
            for x in self.im_list
        ]
        self.im_hw = im_hw
        self.crop_w = crop_w
        self.phase = phase.upper()
        self.seed = 0 if seed is None else seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _item_rng(self, ind):
        return np.random.RandomState(
            (self.seed * 1000003 + self._epoch * 7919 + ind) % (2**31)
        )

    def __len__(self):
        return len(self.im_list)

    def _load(self, path, crop, gamma=False):
        import cv2

        im = cv2.imread(path)
        if im is None:
            raise FileNotFoundError(path)
        if im.ndim == 3:
            im = im[:, :, ::-1]
        rs, re, cs, ce = crop
        im = np.ascontiguousarray(im[rs:re, cs:ce]).astype(np.float32)
        if gamma:
            im = 2.0 * (im / 255.0) ** 2.2 - 1.0
        else:
            im = (im - 127.5) / 127.5
        if im.ndim == 2:
            im = im[:, :, None]
        return im

    def __getitem__(self, ind):
        import cv2

        ind = ind % len(self.im_list)
        rng = self._item_rng(ind)
        h, w = self.im_hw
        if self.phase == "TRAIN":
            lo, hi = self.crop_w
            cw = int(np.round((hi - lo) * rng.random_sample() + lo))
            ch = int(h / w * cw)
            rs = int(np.round((480 - ch) * rng.random_sample()))
            cs = int(np.round((640 - cw) * rng.random_sample()))
            crop = (rs, rs + ch, cs, cs + cw)
        else:
            ch, cw = 480, 640
            crop = (0, 480, 0, 640)

        seg = 0.5 * (self._load(self.seg_list[ind], crop) + 1.0)[:, :, 0:1]
        im = 0.5 * (self._load(self.im_list[ind], crop, gamma=True) + 1.0)
        normal = self._load(self.normal_list[ind], crop)
        normal = normal / np.sqrt(
            np.maximum(np.sum(normal * normal, axis=2, keepdims=True), 1e-5)
        )
        depth = cv2.imread(self.depth_list[ind], -1)
        if depth is None:
            raise FileNotFoundError(self.depth_list[ind])
        depth = depth[crop[0] : crop[1], crop[2] : crop[3]].astype(np.float32)

        def rsz(x, interp=cv2.INTER_LINEAR):
            return cv2.resize(x, (w, h), interpolation=interp)

        if (ch, cw) != (h, w):
            depth = rsz(depth)
            normal = rsz(normal)
            seg = rsz(seg[:, :, 0])[:, :, None]
            im = rsz(im)
        depth = depth[:, :, None] if depth.ndim == 2 else depth
        seg_depth = np.logical_and(depth > 1, depth < 10).astype(np.float32)
        normal = normal / np.maximum(
            np.sqrt(np.sum(normal * normal, axis=2, keepdims=True)), 1e-5
        )

        if self.phase == "TRAIN":
            if rng.random_sample() > 0.5:
                normal = np.ascontiguousarray(normal[:, ::-1])
                normal[:, :, 0] = -normal[:, :, 0]
                depth = np.ascontiguousarray(depth[:, ::-1])
                seg = np.ascontiguousarray(seg[:, ::-1])
                seg_depth = np.ascontiguousarray(seg_depth[:, ::-1])
                im = np.ascontiguousarray(im[:, ::-1])
            scale = 1 + (rng.random_sample(3) * 0.4 - 0.2)
            im = im * scale.reshape(1, 1, 3)

        return {
            "im": im.astype(np.float32),
            "normal": normal.astype(np.float32),
            "depth": depth.astype(np.float32),
            "seg_normal": seg.astype(np.float32),
            "seg_depth": seg_depth,
            "name": self.im_list[ind],
        }
