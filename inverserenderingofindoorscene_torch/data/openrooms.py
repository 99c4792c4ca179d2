"""OpenRooms synthetic dataset pipeline: numpy items and batches, NHWC.

The counterpart of the JAX package's ``data/openrooms.py``; for the same
files, seed and epoch its float outputs are bit-equal to the JAX loader's.
It reproduces every transform of the reference ``BatchLoader``
(dataLoader.py:15-319):

  * scene lists from ``{train,test}.txt`` over the six xml render dirs
    with the DiffLight/DiffMat path-derivation rules (75-91);
  * LDR maps resized with PIL's Lanczos to (H, W), mapped to [-1, 1]
    (loadImage, 219-237); albedo de-gamma'd ``(0.5(x+1))^2.2``, normals
    unit, rough channel 0;
  * the HDR image through cv2 (BGR -> RGB) and INTER_AREA, scaled so the
    95th-percentile masked intensity hits 0.85-0.95 (TRAIN) / 0.90
    (TEST), clipped to [0, 1] (loadHdr/scaleHdr, 239-259);
  * the binary ``.dat`` depth with its int32 h/w header (loadBinary,
    261-275), INTER_AREA;
  * the mask's {segArea, segEnv, segObj} bands, segObj eroded 7x7 in
    light mode (120-131);
  * the per-pixel envmap ``imenv_*.hdr`` pooled 2x2 to 8x16 a grid pixel
    in BGR order, scaled by the HDR exposure, with the zero envmap and
    ``env_ind = 0`` where the file is missing (286-319); the native
    decoder (``native/hdr.py``) first, cv2 for a file it rejects;
  * at cascade >= 1, the previous cascade's ``*_{level-1}.h5`` products
    with their normalizations (162-184), through :func:`load_cascade_pre`
    and :func:`load_env_pre`, which also serve the hand-off in memory.

Augmentation draws come from a ``(seed, epoch, item)``-keyed stream, so
any worker gives the same item and a skipped batch prefix reproduces the
data position.  cv2, PIL and scipy are imported where a file is read;
the hand-off's ``.h5`` files are read by the port's HDF5 codec
(``utils/h5.py``, through ``utils/io.read_h5``).  Nothing here touches
torch or CUDA, so spawned loader workers start clean.
"""

from __future__ import annotations

import glob
import os.path as osp
import queue as queue_mod
import random
import struct
import threading
from typing import Optional

import numpy as np

from inverserenderingofindoorscene_torch.utils.io import read_h5

DEFAULT_DIRS = (
    "main_xml",
    "main_xml1",
    "mainDiffLight_xml",
    "mainDiffLight_xml1",
    "mainDiffMat_xml",
    "mainDiffMat_xml1",
)

# a cascade's product -> its file stem, the reference's names
STEMS = {
    "albedo": "imbaseColor_",
    "normal": "imnormal_",
    "rough": "imroughness_",
    "depth": "imdepth_",
    "diffuse": "imdiffuse_",
    "specular": "imspecular_",
    "env": "imenv_",
}
# the next cascade's batch key -> the file stem it is read from
PRE_STEMS = {k + "_pre": v for k, v in STEMS.items() if k != "env"}


def product_path(im_path: str, stem: str, cascade_level: int) -> str:
    """The file of ``im_path``'s cascade-``cascade_level`` product
    ``stem``: ``im_`` -> stem, ``.hdr`` -> ``_{cascade_level}.h5``."""
    return im_path.replace("im_", stem).replace(
        ".hdr", "_%d.h5" % cascade_level)


def pre_path(im_path: str, stem: str, cascade_level: int) -> str:
    """The file of ``im_path``'s previous-cascade product ``stem`` for a
    loader at ``cascade_level`` (>= 1)."""
    return product_path(im_path, stem, cascade_level - 1)


def normalize_cascade_pre(chw: dict) -> dict:
    """One image's six previous-cascade products, CHW arrays keyed as
    ``PRE_STEMS``, -> the cascade input's ``*_pre`` maps, HWC: albedo and
    depth over their mean (clamped at 1e-10) / 3; normal unit (the squared
    norm clamped at 1e-5) and mapped to 0.5(n + 1); rough channel 0 mapped
    to 0.5(r + 1); diffuse and specular over their maximum (clamped at
    1e-10)."""
    albedo = chw["albedo_pre"]
    albedo = albedo / np.maximum(albedo.mean(), 1e-10) / 3.0
    normal = chw["normal_pre"]
    normal = normal / np.sqrt(
        np.maximum(np.sum(normal * normal, axis=0, keepdims=True), 1e-5))
    normal = 0.5 * (normal + 1.0)
    rough = 0.5 * (chw["rough_pre"][0:1] + 1.0)
    depth = chw["depth_pre"]
    depth = depth / np.maximum(depth.mean(), 1e-10) / 3.0
    diffuse = chw["diffuse_pre"]
    diffuse = diffuse / max(diffuse.max(), 1e-10)
    specular = chw["specular_pre"]
    specular = specular / max(specular.max(), 1e-10)
    maps = {"albedo_pre": albedo, "normal_pre": normal, "rough_pre": rough,
            "depth_pre": depth, "diffuse_pre": diffuse,
            "specular_pre": specular}
    return {k: np.ascontiguousarray(v.transpose(1, 2, 0))
            for k, v in maps.items()}


def load_cascade_pre(im_path: str, cascade_level: int) -> dict:
    """The ``*_pre`` maps of ``im_path`` for a loader at ``cascade_level``
    (>= 1), read from the previous cascade's files."""
    return normalize_cascade_pre({
        key: read_h5(pre_path(im_path, stem, cascade_level),
                     hwc_from_chw=False)
        for key, stem in PRE_STEMS.items()})


def load_env_pre(im_path: str, cascade_level: int, env_ind: float,
                 sg_num: int = 12, env_rc=(120, 160)):
    """The previous cascade's SG tensor of ``im_path``, HWC [R,C,7K], and
    the image's envmap flag: ``env_ind`` as given, or zeros and 0.0 where
    the file is missing.  Returns (env_pre, env_ind)."""
    path = pre_path(im_path, "imenv_", cascade_level)
    if not osp.isfile(path):
        print("Wrong envmap pred")
        r, c = env_rc
        return np.zeros((r, c, sg_num * 7), np.float32), 0.0
    return read_h5(path), env_ind


def _require(path):
    if not osp.isfile(path):
        raise FileNotFoundError(path)
    return path


class OpenRoomsDataset:
    """Per-item loader over an OpenRooms tree; indexable, stateless
    between items.  ``is_light`` adds ``env_gt`` / ``env_ind`` (and
    ``env_pre`` at cascade >= 1) and erodes the object mask;
    ``is_all_light`` keeps only images with an envmap file (and, at
    cascade >= 1, a previous-cascade SG file)."""

    def __init__(
        self,
        data_root: str,
        dirs=DEFAULT_DIRS,
        im_hw=(240, 320),
        phase: str = "TRAIN",
        cascade_level: int = 0,
        is_light: bool = False,
        is_all_light: bool = False,
        env_hw=(8, 16),
        env_rc=(120, 160),
        sg_num: int = 12,
        seed: Optional[int] = None,
    ):
        phase = phase.upper()
        if phase not in ("TRAIN", "TEST"):
            raise ValueError(f"phase {phase!r} is neither TRAIN nor TEST")
        scene_file = osp.join(
            data_root, "train.txt" if phase == "TRAIN" else "test.txt"
        )
        with open(scene_file) as f:
            scenes = [x.strip() for x in f if x.strip()]

        shapes = sorted(
            osp.join(data_root, d, s) for d in dirs for s in scenes
        )
        self.im_list = []
        for shape in shapes:
            self.im_list += sorted(glob.glob(osp.join(shape, "im_*.hdr")))

        if is_all_light:
            self.im_list = [
                x for x in self.im_list
                if osp.isfile(x.replace("im_", "imenv_"))
            ]
            if cascade_level > 0:
                self.im_list = [
                    x for x in self.im_list
                    if osp.isfile(pre_path(x, "imenv_", cascade_level))
                ]

        self.im_hw = im_hw
        self.phase = phase
        self.cascade_level = cascade_level
        self.is_light = is_light
        self.env_hw = env_hw
        self.env_rc = env_rc
        self.sg_num = sg_num
        self.seed = 0 if seed is None else seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Advance the augmentation stream (``BatchIterator`` calls it each
        epoch: exposures differ per epoch and stay deterministic)."""
        self._epoch = epoch

    def _item_rng(self, ind: int) -> np.random.RandomState:
        """The (seed, epoch, item)-keyed stream: the same draws whichever
        thread or process loads the item."""
        return np.random.RandomState(
            (self.seed * 1000003 + self._epoch * 7919 + ind) % (2**31)
        )

    def __len__(self):
        return len(self.im_list)

    def _paths(self, im_path):
        """dataLoader.py:75-91."""
        def swap(stem, ext, drop=()):
            p = im_path.replace("im_", stem).replace("hdr", ext)
            for token in drop:
                p = p.replace(token, "")
            return p

        return {
            "im": im_path,
            "albedo": swap("imbaseColor_", "png", ("DiffLight",)),
            "normal": swap("imnormal_", "png", ("DiffLight",)),
            "rough": swap("imroughness_", "png", ("DiffLight",)),
            "depth": swap("imdepth_", "dat", ("DiffLight", "DiffMat")),
            "seg": swap("immask_", "png", ("DiffMat",)),
            "env": im_path.replace("im_", "imenv_"),
        }

    def _load_ldr(self, path, is_gamma=False):
        """PIL image -> HWC float in [-1, 1] (loadImage)."""
        from PIL import Image

        h, w = self.im_hw
        im = Image.open(_require(path)).resize([w, h], Image.LANCZOS)
        im = np.asarray(im, dtype=np.float32)
        if is_gamma:
            im = 2.0 * (im / 255.0) ** 2.2 - 1.0
        else:
            im = (im - 127.5) / 127.5
        if im.ndim == 2:
            im = im[:, :, None]
        return im

    def _load_hdr(self, path):
        """cv2 HDR -> HWC RGB at (H, W) (loadHdr)."""
        import cv2

        h, w = self.im_hw
        im = cv2.imread(_require(path), -1)
        if im is None:
            raise ValueError(f"cv2 cannot read {path}")
        im = cv2.resize(im, (w, h), interpolation=cv2.INTER_AREA)
        return np.ascontiguousarray(im[:, :, ::-1]).astype(np.float32)

    def _hdr_pivot(self, hdr, seg):
        """The 95th-percentile masked intensity (scaleHdr), clamped at
        0.1: the k-th order statistic, by partition."""
        h, w = self.im_hw
        k = int(0.95 * h * w * 3)
        arr = (hdr * seg).flatten()
        return np.clip(np.partition(arr, k)[k], 0.1, None)

    def _exposure_scale(self, pivot, rng):
        """Random (TRAIN) or fixed (TEST) exposure over the pivot; one
        draw from ``rng``."""
        if self.phase == "TRAIN":
            return (0.95 - 0.1 * rng.random_sample()) / pivot
        return (0.95 - 0.05) / pivot

    def _load_depth(self, path):
        """int32 h/w header + float32 raster, INTER_AREA to (H, W)
        (loadBinary)."""
        import cv2

        h, w = self.im_hw
        with open(_require(path), "rb") as f:
            height = struct.unpack("i", f.read(4))[0]
            width = struct.unpack("i", f.read(4))[0]
            depth = np.frombuffer(
                f.read(4 * width * height), dtype=np.float32
            ).reshape(height, width)
        depth = cv2.resize(depth, (w, h), interpolation=cv2.INTER_AREA)
        return depth[:, :, None]

    def _load_envmap(self, path, scale=1.0):
        """imenv HDR -> ([R, C, eh*ew, 3] times ``scale``, validity flag)
        (loadEnvmap; the reference's layout is [3, R, C, eh, ew]).  The
        native single-pass decode + 2x2 pool first; a file it rejects
        goes through cv2 and a numpy pool, bit-equal; a file cv2 cannot
        read either gives the zero envmap and flag 0."""
        r, c = self.env_rc
        eh, ew = self.env_hw
        d = eh * ew
        eh0, ew0 = 16, 32
        if eh0 % eh or eh0 // eh != ew0 // ew:
            raise ValueError(f"envmap {eh}x{ew} does not pool 16x32")
        if not osp.isfile(path):
            print("Warning: the envmap %s does not exist." % path)
            return np.zeros((r, c, d, 3), np.float32), 0.0

        from inverserenderingofindoorscene_torch.native import hdr as nhdr

        if nhdr.native_available():
            try:
                return nhdr.decode_rgbe_pooled(path, r, c, eh0, ew0, eh,
                                               ew, scale), 1.0
            except ValueError as e:
                print("Warning: native envmap decode failed (%s); "
                      "falling back to cv2." % e)
        return self._load_envmap_cv2(path, scale)

    def _load_envmap_cv2(self, path, scale=1.0):
        """cv2 decode + numpy pool: the route for a file the native
        decoder rejects, and the native route's reference."""
        import cv2

        r, c = self.env_rc
        eh, ew = self.env_hw
        d = eh * ew
        env = cv2.imread(path, -1)
        if env is None:
            print("Warning: the envmap %s does not exist." % path)
            return np.zeros((r, c, d, 3), np.float32), 0.0
        # the reference keeps cv2's BGR order here (unlike loadHdr)
        s = 16 // eh
        env = env.reshape(r, eh, s, c, ew, s, 3)
        env = env.mean(axis=(2, 5), dtype=np.float32)  # [r, eh, c, ew, 3]
        env = env.transpose(0, 2, 1, 3, 4)
        out = np.ascontiguousarray(env.reshape(r, c, d, 3)).astype(np.float32)
        if scale != 1.0:
            out *= np.float32(scale)
        return out, 1.0

    def __getitem__(self, ind):
        return self._decode_item(ind, self._item_rng(ind))

    def load_raw(self, ind):
        """The epoch-invariant decode of item ``ind``, for the packed item
        cache (``data/cache.py``): ``im`` unscaled with its exposure
        ``pivot`` beside it, ``env_gt`` decoded at scale 1.  An epoch's
        read then redoes one draw and two multiplies."""
        return self._decode_item(ind, None)

    def _decode_item(self, ind, rng):
        """Item ``ind`` decoded: with ``rng``, the direct path (the
        exposure applied, its scale folded into the native envmap
        decode); with ``rng=None``, the epoch-invariant decode."""
        import scipy.ndimage as ndimage

        im_path = self.im_list[ind]
        paths = self._paths(im_path)

        seg = 0.5 * (self._load_ldr(paths["seg"]) + 1.0)[:, :, 0:1]
        seg_area = np.logical_and(seg > 0.49, seg < 0.51).astype(np.float32)
        seg_env = (seg < 0.1).astype(np.float32)
        seg_obj = seg > 0.9
        if self.is_light:
            seg_obj = ndimage.binary_erosion(
                seg_obj[:, :, 0], structure=np.ones((7, 7)), border_value=1
            )[:, :, None]
        seg_obj = seg_obj.astype(np.float32)

        im = self._load_hdr(paths["im"])
        pivot = self._hdr_pivot(im, seg)
        if rng is None:
            scale = 1.0
        else:
            scale = self._exposure_scale(pivot, rng)
            im = np.clip(scale * im, 0, 1)

        albedo = self._load_ldr(paths["albedo"])
        albedo = (0.5 * (albedo + 1.0)) ** 2.2

        normal = self._load_ldr(paths["normal"])
        normal = normal / np.sqrt(
            np.maximum(np.sum(normal * normal, axis=2, keepdims=True), 1e-5)
        )

        rough = self._load_ldr(paths["rough"])[:, :, 0:1]
        depth = self._load_depth(paths["depth"])

        out = {
            "im": im,
            "albedo": albedo,
            "normal": normal,
            "rough": rough,
            "depth": depth,
            "seg_area": seg_area,
            "seg_env": seg_env,
            "seg_brdf": seg_obj,
            "seg_all": seg_area + seg_obj,
            "name": im_path,
        }
        if rng is None:
            out["pivot"] = np.float32(pivot)

        if self.is_light:
            # the exposure scale folded into the decode
            env, env_ind = self._load_envmap(paths["env"], scale=scale)
            out["env_gt"] = env
            if self.cascade_level > 0:
                out["env_pre"], env_ind = load_env_pre(
                    im_path, self.cascade_level, env_ind, self.sg_num,
                    self.env_rc)
            out["env_ind"] = np.array([env_ind], np.float32)

        if self.cascade_level > 0:
            out.update(load_cascade_pre(im_path, self.cascade_level))
        return out


_WORKER_DS = None


def _proc_init(ds):
    global _WORKER_DS
    _WORKER_DS = ds


def _proc_get(args):
    epoch, idx = args
    if hasattr(_WORKER_DS, "set_epoch"):  # the contract of __iter__
        _WORKER_DS.set_epoch(epoch)
    return _WORKER_DS[idx]


class BatchIterator:
    """Shuffling, prefetching batcher over an indexable dataset (the
    reference's DataLoader with 6-16 worker processes, trainBRDF.py:
    136-137).

    ``mode="thread"``: worker threads, enough where an item's cost is
    GIL-releasing work (the native envmap decode, cv2, the hand-off
    files' LZF).
    ``mode="process"``: a persistent pool of spawned processes (items
    return by pickle), which wins where an item's cost is GIL-held numpy
    and PIL work, as in the BRDF stage.  A dataset with ``get_batch``
    (the packed item cache) collates its own batches, outside process
    mode.  Each epoch calls the dataset's ``set_epoch``; batches are
    numpy dicts (``name`` a list).  Call
    :meth:`close` to stop the process pool."""

    def __init__(self, dataset, batch_size, shuffle=True, num_workers=4,
                 drop_last=True, seed=0, mode="thread"):
        if mode not in ("thread", "process"):
            raise ValueError(f"loader mode {mode!r}")
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.workers = num_workers
        self.drop_last = drop_last
        self.mode = mode
        self.rng = random.Random(seed)
        self._epoch_counter = 0
        self._pool = None  # lazy persistent process pool

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor

        epoch = self._epoch_counter
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(epoch)
        self._epoch_counter += 1

        order = list(range(len(self.ds)))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [
            order[i : i + self.bs] for i in range(0, len(order), self.bs)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.bs]

        q = queue_mod.Queue(maxsize=max(self.workers, 1) * 2)
        stop = object()
        abort = threading.Event()

        def put(item):
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue_mod.Full:
                    continue
            return False

        # a dataset with get_batch (the packed cache) collates into its
        # own recycled buffers, cheaper than items and np.stack
        use_get_batch = hasattr(self.ds, "get_batch") and not (
            self.mode == "process" and self.workers > 1)

        def produce():
            try:
                if use_get_batch:
                    for idxs in batches:
                        if abort.is_set():
                            return
                        if not put(self.ds.get_batch(idxs)):
                            return
                elif self.mode == "process" and self.workers > 1:
                    pool = self._process_pool()
                    chunk = max(1, self.bs // (2 * self.workers))
                    for idxs in batches:
                        if abort.is_set():
                            return
                        items = list(pool.map(
                            _proc_get, [(epoch, i) for i in idxs],
                            chunksize=chunk))
                        if not put(self._collate(items)):
                            return
                elif self.workers > 1:
                    with ThreadPoolExecutor(max_workers=self.workers) as pool:
                        for idxs in batches:
                            if abort.is_set():
                                return
                            items = list(pool.map(self.ds.__getitem__, idxs))
                            if not put(self._collate(items)):
                                return
                else:
                    for idxs in batches:
                        if abort.is_set():
                            return
                        if not put(self._collate([self.ds[i]
                                                  for i in idxs])):
                            return
            except Exception as e:  # handed to the consumer, raised there
                put(e)
                return
            put(stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # an early break or close releases the producer
            abort.set()

    def _process_pool(self):
        """The persistent spawned pool: the dataset goes to each worker
        once, through the initializer; an item's traffic is (epoch, index)
        in and its arrays out.  spawn, not fork: the caller has live
        threads (the producer, torch's), and a fork can inherit a lock
        held mid-operation."""
        if self._pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            from inverserenderingofindoorscene_torch.native import hdr as nhdr

            # build the native decoder before the workers start, so they
            # do not race to compile it
            nhdr.native_available()
            self._pool = ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=mp.get_context("spawn"),
                initializer=_proc_init,
                initargs=(self.ds,),
            )
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    @staticmethod
    def _collate(items):
        out = {}
        for k in items[0]:
            if k == "name":
                out[k] = [it[k] for it in items]
            else:
                out[k] = np.stack([it[k] for it in items])
        return out
