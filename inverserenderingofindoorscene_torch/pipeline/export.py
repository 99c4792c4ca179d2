"""Cascade hand-off: the cascade-k products of the frozen BRDF + light
stack, written beside the dataset's images for cascade k+1's training.

The counterpart of the JAX package's ``pipeline/export.py`` (the
reference's outputBRDFLight): :func:`export_step` runs ``light_step``
without gradients and returns the seven products, :func:`write_products`
writes them as per-image ``*_{cascade}.h5`` files (``utils/io.py``: CHW
``data`` dataset, LZF), under the reference's names (``_STEMS``, the
reader's ``data/openrooms.STEMS``), skipping files that exist.  The
files are written and read by the port's HDF5 codec (``utils/h5.py``),
byte for byte what h5py writes; ``data/openrooms.py`` reads them back.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from inverserenderingofindoorscene_torch.core.scale import mean_normalize
from inverserenderingofindoorscene_torch.data.openrooms import (
    STEMS as _STEMS,
    product_path,
)
from inverserenderingofindoorscene_torch.pipeline.light import light_step
from inverserenderingofindoorscene_torch.utils.io import write_h5


def export_step(brdf_nets, light_nets, batch: dict, offset: float = 1.0,
                use_kernels: bool = True):
    """The seven products of one batch, NHWC tensors: albedo and depth
    mean-normalized to 1/3, normal, rough, the rendered diffuse and
    specular [B,R,C,3], and ``env`` = the 84-channel SG tensor
    ``sg_flat`` [B,R,C,7K].  ``use_kernels`` as in ``light_step`` (one
    ``sg_envmap_fwd`` and one ``render_sg_fwd`` launch a call on CUDA
    tensors).  Returns (products, losses)."""
    with torch.no_grad():
        losses, aux = light_step(brdf_nets, light_nets, batch, offset=offset,
                                 use_kernels=use_kernels)
    preds = aux["brdf_preds"]
    products = {
        "albedo": mean_normalize(preds["albedo"]),
        "normal": preds["normal"],
        "rough": preds["rough"],
        "depth": mean_normalize(preds["depth"]),
        "diffuse": aux["diffuse"],
        "specular": aux["specular"],
        "env": aux["sg"]["sg_flat"],
    }
    return products, losses


def write_products(products: dict, names, cascade_level: int, env_ind=None,
                   skip_existing: bool = True) -> list:
    """Write image n's products beside ``names[n]`` (a dataset ``im_*.hdr``
    path): ``im_`` becomes the product's stem and ``.hdr`` becomes
    ``_{cascade_level}.h5``.  ``env`` is written only where ``env_ind[n]
    == 1``; with ``skip_existing`` a file that exists is left alone.
    Returns the paths written."""
    products = {k: v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v) for k, v in products.items()}
    written = []
    for n, im_name in enumerate(names):
        for key, stem in _STEMS.items():
            out = product_path(im_name, stem, cascade_level)
            if key == "env" and env_ind is not None and env_ind[n] != 1:
                continue
            if skip_existing and osp.isfile(out):
                continue
            write_h5(products[key][n], out)
            written.append(out)
    return written
