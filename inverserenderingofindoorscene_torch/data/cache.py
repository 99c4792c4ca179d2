"""The packed item cache: an OpenRooms dataset decoded once into
memmapped shards, so that an epoch reads a slice and multiplies.

The counterpart of the JAX package's ``data/cache.py``, with the same
version, signature, shard layout, ``meta.json`` and build bitmap, so a
cache either package built serves the other.  Every costly transform of
the loader is the same in every epoch (the RGBE decode and 2x2 pool of
the 1920x5120 envmap, the LDR decodes and resizes, the mask erosion, the
depth read, the exposure's 95th-percentile pivot); the only per-epoch
randomness is the exposure scale, one draw and a multiply.

Exactness, against ``OpenRoomsDataset`` on the same files, seed and
epoch:
  * every LDR field, ``depth``, the segs and the exposure scale are
    bit-equal (the cache stores the decoded float32 arrays and the pivot;
    the draw comes from the same (seed, epoch, item)-keyed stream);
  * ``im`` is bit-equal (the same ``np.clip(scale * hdr, 0, 1)``);
  * ``env_gt`` is within ~1 ulp: the direct native decode folds the
    scale into the pool's sum, the cache multiplies the pooled tensor;
  * ``half=True`` stores ``im`` and ``env_gt`` as float16 (saturating at
    65504): ~1e-3 relative, not bitwise.
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
import sys
import threading
from typing import Optional

import numpy as np

from inverserenderingofindoorscene_torch.data.openrooms import pre_path

CACHE_VERSION = 1

# fields made at read time, not stored
_DERIVED = ("seg_all", "name")
# 0/1 float masks stored as uint8 (exact, 4x smaller)
_U8_FIELDS = ("seg_area", "seg_env", "seg_brdf")
# the HDR tensors that half=True stores as float16
_HALF_FIELDS = ("im", "env_gt")


class _BufferPool:
    """Recycled batch buffers: faulting in fresh memory for every batch
    costs more than the cached read itself.  A buffer is handed out again
    only when nothing outside the pool holds it (its reference count), so
    a consumer that keeps batches is safe; the pool grows to the depth in
    flight."""

    def __init__(self):
        self._pools: dict = {}
        # two producer threads over one dataset must not both see the
        # same free buffer
        self._lock = threading.Lock()

    # a spawned worker gets an empty pool
    def __getstate__(self):
        return {}

    def __setstate__(self, state):
        self.__init__()

    def get(self, key, shape, dtype):
        with self._lock:
            pool = self._pools.setdefault(key, [])
            for a in pool:
                # 3: the pool's reference, the loop variable and
                # getrefcount's argument; nothing else holds it
                if (a.shape == shape and a.dtype == dtype
                        and sys.getrefcount(a) == 3):
                    return a
            a = np.zeros(shape, dtype)  # the pages are faulted in once
            pool.append(a)
            return a


class CachedOpenRoomsDataset:
    """``OpenRoomsDataset`` read from the packed cache: the same
    ``__getitem__`` items, the same (seed, epoch, item)-keyed exposure
    draws, and :meth:`get_batch` for ``BatchIterator``.

    The cache's directory is named by a signature of the loader's
    configuration and the source files' (path, size, mtime): a changed
    tree builds a new cache.  ``meta.json``, written last, marks a
    complete build; a killed build resumes (:meth:`_build`)."""

    def __init__(self, dataset, cache_root: str, workers: int = 4,
                 half: bool = False, verbose: bool = True):
        self.ds = dataset
        self.half = bool(half)
        self.verbose = verbose
        sig = self._signature()
        name = "irois_%s%s" % (sig[:16], "_h" if self.half else "")
        self.dir = osp.join(cache_root, name)
        self._mm: Optional[dict] = None
        self._pool = _BufferPool()
        # a complete cache is read as it is
        self.reused = osp.isfile(osp.join(self.dir, "meta.json"))
        if not self.reused:
            self._build(workers)

    def __len__(self):
        return len(self.ds)

    @property
    def im_list(self):
        return self.ds.im_list

    def set_epoch(self, epoch: int):
        self.ds.set_epoch(epoch)

    def _signature(self) -> str:
        ds = self.ds
        files = []
        for im_path in ds.im_list:
            paths = list(ds._paths(im_path).values())
            if ds.cascade_level > 0:
                stems = ["imbaseColor_", "imnormal_", "imroughness_",
                         "imdepth_", "imdiffuse_", "imspecular_"]
                if ds.is_light:
                    stems.append("imenv_")
                paths += [pre_path(im_path, s, ds.cascade_level)
                          for s in stems]
            for p in paths:
                try:
                    st = os.stat(p)
                    files.append((p, st.st_size, st.st_mtime_ns))
                except OSError:
                    files.append((p, -1, -1))
        spec = {
            "version": CACHE_VERSION,
            "im_hw": list(ds.im_hw),
            "env_rc": list(ds.env_rc),
            "env_hw": list(ds.env_hw),
            "is_light": ds.is_light,
            "cascade_level": ds.cascade_level,
            "sg_num": ds.sg_num,
            "files": files,
        }
        blob = json.dumps(spec, sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()

    def _field_dtype(self, key, arr):
        if key in _U8_FIELDS:
            return np.uint8
        if self.half and key in _HALF_FIELDS:
            return np.float16
        return arr.dtype

    _BUILD_CHUNK = 256  # items between durable progress points

    def _build(self, workers: int):
        """Decode every item into the shards, in chunks.  ``built.u8``
        holds a byte an item: a chunk's field rows are flushed first and
        only then its bytes set and flushed, so after a kill every set
        byte stands on flushed rows, and the next build decodes only the
        items whose byte is 0 (a chunk flushed but not marked is written
        again, to the same values).  ``meta.json`` comes last."""
        import time
        from concurrent.futures import ThreadPoolExecutor

        ds = self.ds
        n = len(ds)
        if n == 0:
            raise ValueError("the dataset is empty")
        os.makedirs(self.dir, exist_ok=True)
        t0 = time.time()
        raw0 = ds.load_raw(0)
        shapes = {}
        for k, v in raw0.items():
            if k in _DERIVED:
                continue
            v = np.asarray(v)
            shapes[k] = ((n,) + v.shape, self._field_dtype(k, v))

        bpath = osp.join(self.dir, "built.u8")
        resume = osp.isfile(bpath) and osp.getsize(bpath) == n and all(
            osp.isfile(osp.join(self.dir, k + ".npy")) for k in shapes)
        if resume:
            built = np.memmap(bpath, dtype=np.uint8, mode="r+", shape=(n,))
            mms = {}
            for k, (shape, dtype) in shapes.items():
                m = np.load(osp.join(self.dir, k + ".npy"), mmap_mode="r+")
                if m.shape != shape or m.dtype != dtype:
                    resume = False
                    break
                mms[k] = m
        if not resume:
            built = np.memmap(bpath, dtype=np.uint8, mode="w+", shape=(n,))
            mms = {
                k: np.lib.format.open_memmap(
                    osp.join(self.dir, k + ".npy"), mode="w+", dtype=dtype,
                    shape=shape)
                for k, (shape, dtype) in shapes.items()
            }

        def write(ind, raw=None):
            raw = ds.load_raw(ind) if raw is None else raw
            for k, mm in mms.items():
                v = np.asarray(raw[k])
                if mm.dtype == np.float16:
                    v = np.minimum(v, np.float32(65504.0))
                mm[ind] = v  # distinct rows: safe across threads

        todo = np.flatnonzero(built == 0)
        done0 = n - len(todo)
        if self.verbose and done0:
            print("packed cache: resuming build, %d/%d items already "
                  "durable" % (done0, n), flush=True)
        if not built[0]:
            write(0, raw0)
        pool = (ThreadPoolExecutor(max_workers=workers)
                if workers > 1 else None)
        try:
            for lo in range(0, len(todo), self._BUILD_CHUNK):
                chunk = [i for i in todo[lo:lo + self._BUILD_CHUNK]
                         if i != 0]
                if pool is not None:
                    list(pool.map(write, chunk))
                else:
                    for i in chunk:
                        write(i)
                # the rows first, then the bytes that vouch for them
                for mm in mms.values():
                    mm.flush()
                built[todo[lo:lo + self._BUILD_CHUNK]] = 1
                built.flush()
        finally:
            if pool is not None:
                pool.shutdown()
        meta = {
            "version": CACHE_VERSION,
            "n": n,
            "half": self.half,
            "fields": sorted(mms),
        }
        tmp = osp.join(self.dir, ".meta.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, osp.join(self.dir, "meta.json"))
        if self.verbose:
            print("packed cache: built %d items (%d new) in %.1fs at %s"
                  % (n, len(todo), time.time() - t0, self.dir), flush=True)

    def _maps(self) -> dict:
        if self._mm is None:
            with open(osp.join(self.dir, "meta.json")) as f:
                meta = json.load(f)
            if meta["n"] != len(self.ds):
                raise ValueError(f"the cache at {self.dir} holds "
                                 f"{meta['n']} items, the dataset "
                                 f"{len(self.ds)}")
            self._mm = {
                k: np.load(osp.join(self.dir, k + ".npy"), mmap_mode="r")
                for k in meta["fields"]
            }
        return self._mm

    def __getitem__(self, ind):
        ds = self.ds
        mm = self._maps()
        rng = ds._item_rng(ind)
        # the direct path's draw order: the exposure first
        scale = ds._exposure_scale(np.float32(mm["pivot"][ind]), rng)

        out = {}
        for k, m in mm.items():
            if k == "pivot":
                continue
            row = m[ind]
            if k == "im":
                out[k] = np.clip(scale * np.asarray(row, np.float32), 0, 1)
            elif k == "env_gt":
                out[k] = np.asarray(row, np.float32) * np.float32(scale)
            elif m.dtype == np.uint8:
                out[k] = np.asarray(row, np.float32)
            else:
                out[k] = np.asarray(row)
        out["seg_all"] = out["seg_area"] + out["seg_brdf"]
        out["name"] = ds.im_list[ind]
        return out

    def get_batch(self, idxs):
        """The collated batch of ``idxs``, read into recycled buffers: one
        pass a field (read, multiply, write for the two exposure-scaled
        tensors, a copy otherwise), no ``np.stack``.  ``BatchIterator``
        calls it in place of items and collate."""
        ds = self.ds
        mm = self._maps()
        n = len(idxs)
        out = {}
        for k, m in mm.items():
            if k == "pivot":
                continue
            dt = (np.float32 if m.dtype in (np.uint8, np.float16)
                  else m.dtype)
            out[k] = self._pool.get(k, (n,) + m.shape[1:], dt)
        seg_all = self._pool.get("seg_all", out["seg_area"].shape,
                                 np.float32)
        for j, ind in enumerate(idxs):
            rng = ds._item_rng(ind)
            scale = ds._exposure_scale(np.float32(mm["pivot"][ind]), rng)
            for k, buf in out.items():
                row = mm[k][ind]
                if k == "im":
                    np.multiply(row, scale, out=buf[j])
                    np.clip(buf[j], 0, 1, out=buf[j])
                elif k == "env_gt":
                    np.multiply(row, np.float32(scale), out=buf[j])
                else:
                    np.copyto(buf[j], row, casting="unsafe")
            np.add(out["seg_area"][j], out["seg_brdf"][j], out=seg_all[j])
        out["seg_all"] = seg_all
        out["name"] = [ds.im_list[i] for i in idxs]
        return out

    # spawned process workers get the dataset by pickle
    def __getstate__(self):
        st = self.__dict__.copy()
        st["_mm"] = None  # opened again in the worker
        st["_pool"] = _BufferPool()
        return st
