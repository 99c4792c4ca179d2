"""Image writers and the cascade hand-off's file format (NHWC numpy).

The counterpart of the JAX package's ``utils/io.py`` (the reference's
utils.py): sRGB conversion, the PNG writer and the whole-batch grid of
the training previews, the envmap mosaic and SG shading images of the
test CLIs, and the hand-off's ``.h5`` files, one
LZF-compressed ``data`` dataset a file, stored CHW as the reference
writes it.  The files go through the port's own HDF5 codec
(``utils/h5.py``), which writes h5py's bytes: for the same array the two
packages write the same file, so either package's cascade-0 products feed
the other's cascade 1.  PIL is imported where a PNG is written, so the
rest of the port runs without it.
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
    from inverserenderingofindoorscene_torch.utils import h5

    arr = np.asarray(arr)
    if chw_from_hwc and arr.ndim == 3:
        arr = arr.transpose(2, 0, 1)
    h5.write(path, arr)


def read_h5(path: str, hwc_from_chw: bool = True) -> np.ndarray:
    """The ``data`` dataset of ``path``; a 3-d one comes back [H,W,C]
    (``hwc_from_chw``)."""
    from inverserenderingofindoorscene_torch.utils import h5

    arr = h5.read(path)
    if hwc_from_chw and arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    return arr


def envmap_mosaic(envmap: np.ndarray, nrows: int = 12, ncols: int = 8,
                  env_height: int = 8, env_width: int = 16,
                  gap: int = 1) -> np.ndarray:
    """[R, C, eh, ew, 3] (or [R, C, eh*ew, 3]) -> a mosaic [H', W', 3] in
    [0, 1]: the lighting grid subsampled to nrows x ncols panels with
    ``gap``-pixel gaps (utils.py:102-128)."""
    if envmap.ndim == 4:
        r, c = envmap.shape[:2]
        envmap = envmap.reshape(r, c, env_height, env_width, 3)
    env_row, env_col = envmap.shape[0], envmap.shape[1]
    iy = max(int(env_row / nrows), 1)
    ix = max(int(env_col / ncols), 1)
    lnr = len(np.arange(0, env_row, iy))
    lnc = len(np.arange(0, env_col, ix))
    out = np.ones([lnr * (env_height + gap) + gap,
                   lnc * (env_width + gap) + gap, 3], np.float32)
    for r in range(0, env_row, iy):
        for c in range(0, env_col, ix):
            rs = (r // iy) * (env_height + gap)
            cs = (c // ix) * (env_width + gap)
            out[rs:rs + env_height, cs:cs + env_width] = envmap[r, c]
    return np.clip(out, 0, 1)


def write_envmap_mosaic(envmap: np.ndarray, path: str, **kw):
    """The mosaic as a PNG with the 1/2.2 gamma (utils.py:126-128)."""
    write_image(envmap_mosaic(envmap, **kw), path, gamma=True)


def pred_to_shading(sg_flat: np.ndarray, env_width: int = 32,
                    env_height: int = 16, sg_num: int = 12) -> np.ndarray:
    """The diffuse shading of a squashed SG tensor (utils.py:156-195),
    numpy, NHWC: ``sg_flat`` [R, C, 7K] in the [axis | lamb | weight]
    layout -> [R, C, 3], the cos(El) sin(El)-weighted hemisphere sum of
    the SG envmap, clamped at 0."""
    r, c = sg_flat.shape[:2]
    az = ((np.arange(env_width) + 0.5) / env_width - 0.5) * 2 * np.pi
    el = ((np.arange(env_height) + 0.5) / env_height) * np.pi / 2.0
    az, el = np.meshgrid(az, el)
    ls = np.stack([np.sin(el) * np.cos(az), np.sin(el) * np.sin(az),
                   np.cos(el)], axis=-1).reshape(-1, 3)
    env_weight = (np.cos(el) * np.sin(el)).reshape(-1)

    axis = sg_flat[..., :sg_num * 3].reshape(r, c, sg_num, 3)
    lamb = np.tan(np.pi / 2.0 * 0.999 * sg_flat[..., sg_num * 3:sg_num * 4])
    weight = np.tan(np.pi / 2.0 * 0.999 * sg_flat[..., sg_num * 4:]
                    ).reshape(r, c, sg_num, 3)

    cos = np.einsum("rcks,ds->rckd", axis, ls)
    e = np.exp(lamb[..., None] * (cos - 1.0))  # [R,C,K,D]
    env = np.einsum("rckd,rcke->rcde", e, weight)
    shading = np.einsum("rcde,d->rce", env, env_weight)
    return np.maximum(shading, 0.0)
