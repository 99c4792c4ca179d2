"""Image writers and the cascade hand-off's file format (NHWC numpy).

The counterpart of the JAX package's ``utils/io.py`` (the reference's
utils.py): sRGB conversion, the PNG writer and the whole-batch grid of
the training previews, and the hand-off's ``.h5`` files, one
LZF-compressed ``data`` dataset a file, stored CHW as the reference
writes it.  For the same array the two packages write the same bytes, so
either package's cascade-0 products feed the other's cascade 1.  PIL and
h5py are imported where a file is written or read, so the rest of the
port runs without them.
"""

from __future__ import annotations

import numpy as np


def srgb2rgb(srgb: np.ndarray) -> np.ndarray:
    """sRGB -> linear (utils.py:10-16)."""
    out = np.where(
        srgb <= 0.04045,
        srgb / 12.92,
        np.power(np.clip((srgb + 0.055) / 1.055, 0, None), 2.4),
    )
    return out.astype(srgb.dtype)


def rgb2srgb(rgb: np.ndarray) -> np.ndarray:
    out = np.where(
        rgb <= 0.0031308,
        rgb * 12.92,
        1.055 * np.power(np.clip(rgb, 0, None), 1 / 2.4) - 0.055,
    )
    return out.astype(rgb.dtype)


def write_image(img: np.ndarray, path: str, gamma: bool = False):
    """[H, W, C] float in [0,1] -> PNG, optional 1/2.2 gamma (utils.py:65-77)."""
    from PIL import Image

    img = np.clip(np.asarray(img), 0, 1)
    if gamma:
        img = np.power(img, 1.0 / 2.2)
    img = (255 * img).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    Image.fromarray(img).save(path)


def image_grid(
    imgs: np.ndarray, nrow: int = 8, padding: int = 2, pad_value: float = 0.0
) -> np.ndarray:
    """[B, H, W, C] -> one [H', W', C] grid image.

    The torchvision ``vutils.save_image`` layout the reference uses for its
    whole-batch previews (trainBRDF.py:334-369): ``nrow`` images per grid
    row, ``padding`` pixels between and around tiles."""
    imgs = np.asarray(imgs)
    if imgs.ndim == 3:
        imgs = imgs[None]
    b, h, w, c = imgs.shape
    ncol = min(nrow, b)
    nr = (b + ncol - 1) // ncol
    out = np.full(
        (nr * (h + padding) + padding, ncol * (w + padding) + padding, c),
        pad_value,
        imgs.dtype,
    )
    for i in range(b):
        r, cc = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = cc * (w + padding) + padding
        out[y : y + h, x : x + w] = imgs[i]
    return out


def write_image_grid(imgs: np.ndarray, path: str, gamma: bool = False, **kw):
    """Whole-batch PNG grid (the vutils.save_image call sites)."""
    write_image(image_grid(imgs, **kw), path, gamma=gamma)


def write_h5(arr: np.ndarray, path: str, chw_from_hwc: bool = True) -> None:
    """Write ``arr`` as the ``data`` dataset of a new file at ``path``, LZF
    compressed; an [H,W,C] array is stored [C,H,W] (``chw_from_hwc``)."""
    import h5py

    arr = np.asarray(arr)
    if chw_from_hwc and arr.ndim == 3:
        arr = arr.transpose(2, 0, 1)
    with h5py.File(path, "w") as hf:
        hf.create_dataset("data", data=arr, compression="lzf")


def read_h5(path: str, hwc_from_chw: bool = True) -> np.ndarray:
    """The ``data`` dataset of ``path``; a 3-d one comes back [H,W,C]
    (``hwc_from_chw``)."""
    import h5py

    with h5py.File(path, "r") as hf:
        arr = np.array(hf["data"])
    if hwc_from_chw and arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    return arr
