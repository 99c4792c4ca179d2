"""The cascade hand-off's file format: one LZF-compressed ``data`` dataset
an ``.h5`` file, stored CHW as the reference writes it.

The counterpart of ``write_h5`` and ``read_h5`` of the JAX package's
``utils/io.py``; for the same array the two write the same bytes, so
either package's cascade-0 products feed the other's cascade 1.  h5py is
imported where a file is read or written, so the rest of the port runs
without it.
"""

from __future__ import annotations

import numpy as np


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
