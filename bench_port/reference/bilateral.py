"""The bilateral solver's forward (Barron and Poole; ``BilateralGrid.py``,
``BilateralLayer.py``): the XYLUV grid of a guide image, splat / blur /
slice, bistochastization and Jacobi-preconditioned CG, plain float32.

The grid holds one vertex per occupied cell, in lexicographic order of
the cell's (x, y, luma, u, v) coordinates; a vertex's neighbours along
each dimension are found by looking its shifted coordinates up in that
order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

RGB_TO_YUV = np.array([[0.299, 0.587, 0.114],
                       [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]])
YUV_OFFSET = np.array([0.0, 128.0, 128.0])
DIM = 5


class Params(NamedTuple):
    sigma_luma: float
    sigma_chroma: float
    sigma_spatial: float
    lam: float
    cg_maxiter: int
    a_diag_min: float = 1e-5
    cg_tol: float = 1e-5


# BilateralLayer.py:131-189, by refined map
MODES = {"albedo": Params(8.0, 2.0, 7.0, 200.0, 12),
         "rough": Params(8.0, 2.0, 8.0, 300.0, 10),
         "depth": Params(4.0, 2.0, 4.0, 100.0, 10)}


class Grid(NamedTuple):
    vert_of_pixel: torch.Tensor  # [N] int64
    nbr: torch.Tensor  # [V, 10] int64, -1 where absent

    @property
    def nvert(self) -> int:
        return self.nbr.shape[0]


def build_grid(image255: torch.Tensor, p: Params) -> Grid:
    """The grid of one [H, W, 3] guide in the 0..255 range."""
    h, w = image255.shape[:2]
    dt, dev = image255.dtype, image255.device
    yuv = image255 @ torch.as_tensor(RGB_TO_YUV.T, dtype=dt, device=dev)
    yuv = torch.clamp(yuv + torch.as_tensor(YUV_OFFSET, dtype=dt, device=dev),
                      0.0, 256.0)
    iy, ix = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    coords = torch.stack([
        (ix.to(dt) / p.sigma_spatial).to(torch.int64),
        (iy.to(dt) / p.sigma_spatial).to(torch.int64),
        (yuv[..., 0] / p.sigma_luma).to(torch.int64),
        (yuv[..., 1] / p.sigma_chroma).to(torch.int64),
        (yuv[..., 2] / p.sigma_chroma).to(torch.int64),
    ], dim=-1).reshape(-1, DIM)
    verts, vert_of_pixel = torch.unique(coords, dim=0, sorted=True,
                                        return_inverse=True)
    # mixed-radix codes of the vertices, in the vertices' own order
    lo = verts.amin(0) - 1
    span = verts.amax(0) - lo + 2
    radix = torch.ones(DIM, dtype=torch.int64, device=dev)
    for d in range(DIM - 2, -1, -1):
        radix[d] = radix[d + 1] * span[d + 1]
    codes = ((verts - lo) * radix).sum(1)
    cols = []
    for d in range(DIM):
        for sign in (-1, 1):
            q = codes + sign * radix[d]
            pos = torch.searchsorted(codes, q).clamp(max=codes.shape[0] - 1)
            cols.append(torch.where(codes[pos] == q, pos, -1))
    return Grid(vert_of_pixel, torch.stack(cols, dim=1))


def splat(g: Grid, x: torch.Tensor) -> torch.Tensor:
    """Each vertex's sum of its pixels' values, in one order on every run
    (``index_put_`` with ``accumulate`` sorts by vertex; atomic adds would
    sum in another order each time, which the CG solve amplifies)."""
    out = torch.zeros((g.nvert, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_put_((g.vert_of_pixel,), x, accumulate=True)


def blur(g: Grid, y: torch.Tensor) -> torch.Tensor:
    """10 y + the sum of the present neighbours' values ([1 2 1] per
    dimension)."""
    out = 2.0 * DIM * y
    for d in range(2 * DIM):
        idx = g.nbr[:, d]
        out = out + torch.where((idx >= 0)[:, None], y[idx.clamp(min=0)], 0.0)
    return out


def bistochastize(g: Grid, maxiter: int = 10):
    dev = g.nbr.device
    m = splat(g, torch.ones((g.vert_of_pixel.shape[0], 1),
                            dtype=torch.float32, device=dev))[:, 0]
    n = torch.ones((g.nvert,), dtype=torch.float32, device=dev)
    for _ in range(maxiter):
        n = torch.sqrt(n * m / torch.clamp(blur(g, n[:, None])[:, 0],
                                           min=1e-20))
    return n, n * blur(g, n[:, None])[:, 0]


def pcg(a_fn, b, y0, a_diag, maxiter: int, tol: float):
    """Jacobi-preconditioned CG, one Krylov sequence per channel; a
    channel whose residual norm reaches tol |b| stops moving."""
    minv = (1.0 / a_diag)[:, None]
    r = b - a_fn(y0)
    z = r * minv
    atol = tol * torch.sqrt(torch.sum(b * b, dim=0))
    y, p, rz = y0, z, torch.sum(r * z, dim=0)
    for _ in range(maxiter):
        done = torch.sqrt(torch.sum(r * r, dim=0)) <= atol
        ap = a_fn(p)
        denom = torch.sum(p * ap, dim=0)
        alpha = torch.where(done | (denom == 0), 0.0,
                            rz / torch.where(denom == 0, 1.0, denom))
        y = y + alpha * p
        r = r - alpha * ap
        z = r * minv
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(rz == 0, 0.0,
                           rz_new / torch.where(rz == 0, 1.0, rz))
        p = torch.where(done, p, z + beta * p)
        rz = rz_new
    return y


def solve(guide01: torch.Tensor, target: torch.Tensor, conf: torch.Tensor,
          p: Params):
    """Refine target [H, W, C] with confidence [H, W, 1] on the grid of
    guide01 [H, W, 3] (0..1).  Returns (refined [H, W, C], vertex count)."""
    h, w, c = target.shape
    g = build_grid(guide01 * 255.0, p)
    n, m = bistochastize(g)
    t, cf = target.reshape(-1, c), conf.reshape(-1, 1)
    s = splat(g, torch.cat([cf, t * cf], dim=1))
    w_splat, b = s[:, 0], s[:, 1:]
    y0 = b / torch.clamp(w_splat[:, None], min=1e-10)
    n1, m1, w1 = n[:, None], m[:, None], w_splat[:, None]

    def a_fn(y):
        return p.lam * (m1 * y - n1 * blur(g, n1 * y)) + w1 * y

    a_diag = torch.clamp(p.lam * (m - 2.0 * DIM * n * n) + w_splat,
                         min=p.a_diag_min)
    y = pcg(a_fn, b, y0, a_diag, p.cg_maxiter, p.cg_tol)
    return y[g.vert_of_pixel].reshape(h, w, c), g.nvert
