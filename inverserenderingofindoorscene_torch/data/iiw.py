"""IIW (Intrinsic Images in the Wild) pipeline (NHWC numpy).

The counterpart of the JAX package's ``data/iiw.py``; for the same files,
seed and epoch its outputs are bit-equal to the JAX loader's.

Reproduces the reference ``IIWLoader`` (iiwDataLoader.py:25-232):
aspect-preserving resize so the short side fits, random crop to (H, W),
gamma 2.2 to linear, divide by image max; human point-pair judgements are
mapped through the resize+crop, out-of-crop pairs dropped, darker pairs
re-ordered so point2 is the darker one, and both lists padded (or randomly
subsampled) to ``max_num`` rows with zero weights.  Each list carries a
leading all-zero dummy row exactly like the reference's list
initialization (iiwDataLoader.py:146-147) — the ranking-loss denominator
counts it.
"""

from __future__ import annotations

import json
import os.path as osp

import numpy as np


class IIWDataset:
    def __init__(self, data_root, im_list_file, im_hw=(240, 320),
                 phase="TRAIN", max_num=800, seed=None):
        with open(im_list_file) as f:
            names = [x.strip() for x in f if x.strip()]
        self.im_list = [osp.join(data_root, x) for x in names]
        self.json_list = [x.replace(".png", ".json") for x in self.im_list]
        self.im_hw = im_hw
        self.phase = phase.upper()
        self.max_num = max_num
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

    def __getitem__(self, ind):
        from PIL import Image

        ind = ind % len(self.im_list)
        rng = self._item_rng(ind)
        with open(self.json_list[ind]) as f:
            judgements = json.load(f)

        h, w = self.im_hw
        im = Image.open(self.im_list[ind])
        nw, nh = im.size
        scale_w, scale_h = w / nw, h / nh
        if scale_w > scale_h:
            new_w, new_h = w, int(np.ceil(scale_w * nh))
            cs, rs = 0, rng.randint(new_h - h + 1)
        else:
            new_h, new_w = h, int(np.ceil(scale_h * nw))
            rs, cs = 0, rng.randint(new_w - w + 1)
        im = np.asarray(
            im.resize([new_w, new_h], Image.LANCZOS), dtype=np.float32
        ) / 255.0

        eq_pt, eq_w = [[0, 0, 0, 0]], [0.0]
        dk_pt, dk_w = [[0, 0, 0, 0]], [0.0]
        id_to_points = {p["id"]: p for p in judgements["intrinsic_points"]}
        for c in judgements["intrinsic_comparisons"]:
            darker = c["darker"]
            if darker not in ("1", "2", "E"):
                continue
            weight = c["darker_score"]
            if weight is None or weight <= 0.0:
                continue
            p1 = id_to_points[c["point1"]]
            p2 = id_to_points[c["point2"]]
            if not p1["opaque"] or not p2["opaque"]:
                continue
            r1, c1 = int(p1["y"] * new_h), int(p1["x"] * new_w)
            r2, c2 = int(p2["y"] * new_h), int(p2["x"] * new_w)
            pr1, pc1 = (r1 - rs) / (h - 1), (c1 - cs) / (w - 1)
            pr2, pc2 = (r2 - rs) / (h - 1), (c2 - cs) / (w - 1)
            if not (0 <= pr1 <= 1 and 0 <= pc1 <= 1 and 0 <= pr2 <= 1
                    and 0 <= pc2 <= 1):
                continue
            q1 = [int(pr1 * (h - 1)), int(pc1 * (w - 1))]
            q2 = [int(pr2 * (h - 1)), int(pc2 * (w - 1))]
            if darker == "E":
                eq_pt.append(q1 + q2)
                eq_w.append(weight)
            elif darker == "1":  # point1 darker: store (darker-last) order
                dk_pt.append(q2 + q1)
                dk_w.append(weight)
            else:
                dk_pt.append(q1 + q2)
                dk_w.append(weight)

        def pad(points, weights):
            points = np.asarray(points, np.int32)
            weights = np.asarray(weights, np.float32)
            n = len(points)
            if n < self.max_num:
                points = np.concatenate(
                    [points, np.zeros((self.max_num - n, 4), np.int32)]
                )
                weights = np.concatenate(
                    [weights, np.zeros(self.max_num - n, np.float32)]
                )
            elif n > self.max_num:
                idx = rng.permutation(n)[: self.max_num]
                points, weights, n = points[idx], weights[idx], self.max_num
            return points, weights, np.int32(n)

        eq_pt, eq_w, eq_n = pad(eq_pt, eq_w)
        dk_pt, dk_w, dk_n = pad(dk_pt, dk_w)

        im = im ** 2.2
        im = im[rs : rs + h, cs : cs + w]
        if im.ndim == 2:
            im = im[:, :, None]
        im = im / im.max()

        return {
            "im": im.astype(np.float32),
            "eq_point": eq_pt,
            "eq_weight": eq_w,
            "eq_num": eq_n,
            "darker_point": dk_pt,
            "darker_weight": dk_w,
            "darker_num": dk_n,
            "name": self.im_list[ind],
        }


class ZipDataset:
    """Zip-combine two datasets like the reference ``ConcatDataset``
    (iiwDataLoader.py:14-22): length = max, the shorter one wraps."""

    def __init__(self, *datasets):
        self.datasets = datasets

    def __len__(self):
        return max(len(d) for d in self.datasets)

    def __getitem__(self, i):
        return tuple(d[i % len(d)] for d in self.datasets)
