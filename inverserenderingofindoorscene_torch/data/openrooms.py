"""OpenRooms loading: so far the cascade hand-off's file names and reader.

The counterpart of the JAX package's ``data/openrooms.py`` for the
previous cascade's products (``_pre_path``, ``_load_cascade_pre`` and the
``env_pre`` read of ``_load_item``; the reference's dataLoader.py:162-184):
the ``*_{level-1}.h5`` files that ``pipeline/export.write_products``
writes beside each ``im_*.hdr``, under the names of :data:`STEMS`.  numpy on the host, as the JAX loader;
h5py only where a file is read (``utils/io.py``).  Arrays come back HWC
float32, the batch layout.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from inverserenderingofindoorscene_torch.utils.io import read_h5

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
        r, c = env_rc
        return np.zeros((r, c, sg_num * 7), np.float32), 0.0
    return read_h5(path), env_ind
