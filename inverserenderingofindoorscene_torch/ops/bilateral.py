"""The bilateral-grid solver (Barron-Poole): the grid, its blur kernel,
Jacobi-preconditioned CG and the differentiable solve.

The counterpart of the JAX package's ``ops/bilateral.py`` in its dense
mode, with its NHWC API:

* :func:`build_grid`: pixels -> 5-D XYLUV grid vertices and the ten-column
  neighbour table of the [1 2 1]-per-dimension blur.  The five small
  coordinates pack into one int64 key; ``torch.unique`` gives the vertices
  in the JAX package's lexicographic order and ``torch.searchsorted`` of
  ``key +- delta`` the neighbours.  The grid has exactly as many vertices
  as the image has occupied cells;
* :func:`splat` (a deterministic ``index_put_``) and :func:`slice_`
  (a gather);
* :func:`bilateral_blur`: the blur as a hand-written CUDA kernel
  (``csrc/bilateral_blur.cu``), and :func:`bilateral_blur_plain`, its
  plain PyTorch version;
* :func:`bistochastize`, :func:`_pcg` and the forward and gradient solves;
* :func:`bilateral_solve` / :func:`bilateral_solve_stats`: a
  ``torch.autograd.Function`` whose backward is the gradient CG solve.

Not carried over, because they exist only for XLA's static shapes: the
vertex and edge capacities (``v_max``, ``e_max``), the edge-list blur,
``BucketedSolver`` and its helpers, ``_blocked_scan``; nor the batched
multi-mode ablation ``bilateral_solve_multi``.  The exact-size grid here
is the JAX package's full-capacity grid.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from inverserenderingofindoorscene_torch.ops import build
from inverserenderingofindoorscene_torch.utils.spans import span

# RGB -> YUV matrix + offset of the reference (BilateralGrid.py:13-22).
RGB_TO_YUV = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ]
)
YUV_OFFSET = np.array([0.0, 128.0, 128.0])

DIM = 5  # x, y, luma, u, v
N_DIRS = 2 * DIM  # the neighbour table's columns: (dimension, -1 / +1)
_K2_BITS = 31  # key = (k1 << 31) | k2, k2 < 2^30


class BSParams(NamedTuple):
    """Per-mode hyperparameters (BilateralLayer.py:131-189)."""

    sigma_luma: float
    sigma_chroma: float
    sigma_spatial: float
    lam: float
    a_diag_min: float = 1e-5
    cg_tol: float = 1e-5
    cg_maxiter: int = 10


# mode -> params: 0 albedo, 1 normal, 2 rough, 4 depth
MODE_PARAMS = {
    0: BSParams(8.0, 2.0, 7.0, 200.0, cg_maxiter=12),
    1: BSParams(0.5, 0.5, 0.5, 5.0, cg_maxiter=10),
    2: BSParams(8.0, 2.0, 8.0, 300.0, cg_maxiter=10),
    4: BSParams(4.0, 2.0, 4.0, 100.0, cg_maxiter=10),
}


class BilateralGrid(NamedTuple):
    """The grid of one image.

    vert_of_pixel: [N] int64 vertex of each pixel.
    nbr: [V, 10] int32 neighbour vertices, -1 where absent; columns x-,
        x+, y-, y+, luma-, luma+, u-, u+, v-, v+ (the JAX package's rows).
    """

    vert_of_pixel: torch.Tensor
    nbr: torch.Tensor

    @property
    def nvert(self) -> int:
        return self.nbr.shape[0]


def _pack_widths(h, w, sigma_spatial, sigma_luma, sigma_chroma):
    """Per-field bit widths of the packed coordinates.

    Each field stores coord+1 (the bias keeps -1-shifted queries
    nonnegative) and needs one unit of headroom for the +1 shift, hence
    max+3 values.  key1 = (cx | cy), key2 = (cl | cu | cv), each < 2^30."""

    def bits(maxv):
        return max(int(np.ceil(np.log2(maxv + 3))), 1)

    bx = bits((w - 1) / sigma_spatial)
    by = bits((h - 1) / sigma_spatial)
    blm = bits(256.0 / sigma_luma)
    bu = bits(256.0 / sigma_chroma)
    bv = bits(256.0 / sigma_chroma)
    assert bx + by <= 30, (bx, by)
    assert blm + bu + bv <= 30, (blm, bu, bv)
    return bx, by, blm, bu, bv


def _packed_coords(image_rgb, sigma_spatial, sigma_luma, sigma_chroma,
                   widths):
    """Pixel -> packed (key1, key2) int64 grid coordinates (floor-divided
    XYLUV, BilateralGrid.py:46-59), flattened [N] each.  image_rgb
    [H, W, 3] in the 0..255 range."""
    h, w = image_rgb.shape[:2]
    _, by, _, bu, bv = widths
    dev, dt = image_rgb.device, image_rgb.dtype
    yuv = image_rgb @ torch.as_tensor(RGB_TO_YUV.T, dtype=dt, device=dev)
    yuv = yuv + torch.as_tensor(YUV_OFFSET, dtype=dt, device=dev)
    # keep packed fields in range: guides above 1.0 clip into the top
    # cells, as in the JAX package (the reference's hash aliases instead)
    yuv = torch.clamp(yuv, 0.0, 256.0)
    iy, ix = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    # f32 quotients truncated toward zero, as the JAX astype(int32)
    cx = (ix.to(dt) / sigma_spatial).to(torch.int64)
    cy = (iy.to(dt) / sigma_spatial).to(torch.int64)
    cl = (yuv[..., 0] / sigma_luma).to(torch.int64)
    cu = (yuv[..., 1] / sigma_chroma).to(torch.int64)
    cv = (yuv[..., 2] / sigma_chroma).to(torch.int64)
    k1 = ((cx + 1) << by) | (cy + 1)
    k2 = ((cl + 1) << (bu + bv)) | ((cu + 1) << bv) | (cv + 1)
    return k1.reshape(-1), k2.reshape(-1)


def build_grid(image_rgb: torch.Tensor, sigma_spatial: float,
               sigma_luma: float, sigma_chroma: float) -> BilateralGrid:
    """The grid of one [H, W, 3] image (values scaled to 0..255).

    One int64 key per pixel, ``(k1 << 31) | k2``, orders the vertices as
    the JAX package's two-key sort does.  A +-1 step along one dimension
    is an integer add on the key (the field bias and headroom rule out a
    carry), so each neighbour column is a ``searchsorted`` of the shifted
    vertex keys."""
    h, w = image_rgb.shape[:2]
    widths = _pack_widths(h, w, sigma_spatial, sigma_luma, sigma_chroma)
    _, by, _, bu, bv = widths
    k1, k2 = _packed_coords(image_rgb, sigma_spatial, sigma_luma,
                            sigma_chroma, widths)
    keys, vert_of_pixel = torch.unique((k1 << _K2_BITS) | k2, sorted=True,
                                       return_inverse=True)
    steps = (
        1 << (by + _K2_BITS),  # x
        1 << _K2_BITS,  # y
        1 << (bu + bv),  # luma
        1 << bv,  # u
        1,  # v
    )
    deltas = torch.tensor([s * sign for s in steps for sign in (-1, 1)],
                          dtype=torch.int64, device=keys.device)
    query = keys[:, None] + deltas  # [V, 10]
    pos = torch.searchsorted(keys, query).clamp_(max=keys.shape[0] - 1)
    nbr = torch.where(keys[pos] == query, pos, -1).to(torch.int32)
    return BilateralGrid(vert_of_pixel=vert_of_pixel, nbr=nbr.contiguous())


def splat(grid: BilateralGrid, x: torch.Tensor) -> torch.Tensor:
    """[N, C] pixel values -> [V, C] vertex sums (S x).

    ``index_put_`` with ``accumulate=True`` rather than ``index_add_``:
    on CUDA it sorts the indices and sums each vertex's pixels in one
    order, where ``index_add_``'s atomics sum them in a different order
    on every run, and the CG solve amplifies that last-bit noise to
    ~1e-4 in the refined maps."""
    out = torch.zeros((grid.nvert, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return out.index_put_((grid.vert_of_pixel,), x, accumulate=True)


def slice_(grid: BilateralGrid, y: torch.Tensor) -> torch.Tensor:
    """[V, C] vertex values -> [N, C] per pixel (S^T y, a gather)."""
    return y[grid.vert_of_pixel]


# ---------------------------------------------------------------------------
# The blur: CUDA kernel and plain version
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("bilateral_blur")
    lib.bilateral_blur_f32.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.bilateral_blur_f32.restype = ctypes.c_int
    return lib


def bilateral_blur_plain(grid: BilateralGrid, y: torch.Tensor) -> torch.Tensor:
    """``10 y + sum_d y[nbr[:, d]]`` over the present neighbours, in the
    table's column order (BilateralGrid.py:96-103): the kernel's function
    in plain PyTorch.  y [V, C]."""
    out = 2.0 * DIM * y
    for d in range(N_DIRS):
        idx = grid.nbr[:, d]
        out = out + torch.where((idx >= 0)[:, None], y[idx.clamp(min=0)],
                                0.0)
    return out


def bilateral_blur(grid: BilateralGrid, y: torch.Tensor) -> torch.Tensor:
    """The grid blur: on CUDA tensors the hand-written kernel
    (``csrc/bilateral_blur.cu``), counted in ``bilateral_blur.launches``;
    on CPU tensors :func:`bilateral_blur_plain`.  On the card y must be
    a contiguous float32 [V, C] and ``grid.nbr`` a contiguous int32
    [V, 10] on the same device; anything else raises.  The kernel adds
    in the plain version's order without contracting a multiply-add, so
    the two are bit-equal."""
    nbr = grid.nbr
    if not build.on_card("bilateral_blur", y):
        return bilateral_blur_plain(grid, y)
    v = nbr.shape[0]
    if (y.dim() != 2 or y.shape[0] != v or y.dtype != torch.float32
            or not y.is_contiguous()):
        raise ValueError(f"bilateral_blur: y must be contiguous float32 "
                         f"[{v}, C], got {y.dtype} {tuple(y.shape)}")
    if (tuple(nbr.shape) != (v, N_DIRS) or nbr.dtype != torch.int32
            or not nbr.is_contiguous() or nbr.device != y.device):
        raise ValueError(f"bilateral_blur: nbr must be contiguous int32 "
                         f"[{v}, {N_DIRS}] on {y.device}, got {nbr.dtype} "
                         f"{tuple(nbr.shape)} on {nbr.device}")
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    with span("kernel.bilateral_blur"):
        build.raise_on("bilateral_blur", _lib().bilateral_blur_f32(
            y.data_ptr(), nbr.data_ptr(), out.data_ptr(), v, y.shape[1],
            build.stream(y.device)))
    bilateral_blur.launches += 1
    return out


bilateral_blur.launches = 0


# ---------------------------------------------------------------------------
# Bistochastization and preconditioned CG
# ---------------------------------------------------------------------------


def bistochastize(grid: BilateralGrid, blur=bilateral_blur, maxiter: int = 10):
    """Diagonal bistochastization (BilateralGrid.py:109-120): maxiter + 1
    blurs of one channel.  Returns (n, m), each [V]."""
    npix = grid.vert_of_pixel.shape[0]
    dev = grid.nbr.device
    m = splat(grid, torch.ones((npix, 1), dtype=torch.float32,
                               device=dev))[:, 0]
    n = torch.ones((grid.nvert,), dtype=torch.float32, device=dev)
    for _ in range(maxiter):
        bl = blur(grid, n[:, None])[:, 0]
        n = torch.sqrt(n * m / torch.clamp(bl, min=1e-20))
    m = n * blur(grid, n[:, None])[:, 0]
    return n, m


def _pcg(a_fn, b, y0, a_diag, maxiter: int, tol: float):
    """Jacobi-preconditioned CG with scipy-style rtol stopping (masked).

    Every CG scalar is a per-channel [C] vector, so the channels follow
    their own Krylov sequences, as the reference's per-channel scipy CG
    does, while sharing each [V, C] blur.  The loop runs ``maxiter``
    iterations (1 + maxiter products with A) and freezes a converged
    channel with ``torch.where``: no early exit, no host sync."""
    minv = (1.0 / a_diag)[:, None]
    r = b - a_fn(y0)
    z = r * minv
    atol = torch.clamp(tol * torch.sqrt(torch.sum(b * b, dim=0)), min=0.0)
    y, p, rz = y0, z, torch.sum(r * z, dim=0)
    for _ in range(maxiter):
        done = torch.sqrt(torch.sum(r * r, dim=0)) <= atol  # [C]
        ap = a_fn(p)
        denom = torch.sum(p * ap, dim=0)
        alpha = torch.where(denom.abs() > 0, rz / denom, 0.0)
        alpha = torch.where(done, 0.0, alpha)
        y = y + alpha * p
        r = r - alpha * ap
        z = r * minv
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(rz.abs() > 0, rz_new / rz, 0.0)
        p = torch.where(done, p, z + beta * p)
        rz = rz_new
    return y


def _solve_system(grid, nm, w_splat, b, y0, params: BSParams, blur):
    """Solve (lam A_smooth + diag(w_splat)) y = b, the PCG core of the
    forward (BilateralGrid.py:128-150) and gradient (152-184) solves."""
    n, m = nm
    n1, m1, w1 = n[:, None], m[:, None], w_splat[:, None]

    def a_fn(y):
        smooth = m1 * y - n1 * blur(grid, n1 * y)
        return params.lam * smooth + w1 * y

    a_diag = params.lam * (m - 2.0 * DIM * n * n) + w_splat
    a_diag = torch.clamp(a_diag, min=params.a_diag_min)
    return _pcg(a_fn, b, y0, a_diag, params.cg_maxiter, params.cg_tol)


def _solve_image(grid, target, conf, params: BSParams, nm, blur):
    """Forward solve for one image (BilateralGrid.py:122-150).  target
    [N, C], conf [N, 1]; returns (xhat [N, C], yhat [V, C])."""
    s = splat(grid, torch.cat([conf, target * conf], dim=1))
    w_splat, b = s[:, 0], s[:, 1:]
    y0 = b / torch.clamp(w_splat[:, None], min=1e-10)
    yhat = _solve_system(grid, nm, w_splat, b, y0, params, blur)
    return slice_(grid, yhat), yhat


def _solve_image_grad(grid, nm, g_out, conf, target, yhat, params: BSParams,
                      blur):
    """Gradient solve for one image (BilateralGrid.py:152-184), with the
    grid and (n, m) of the forward.  Returns (grad target [N, C], grad
    conf [N, 1])."""
    ones = torch.ones_like(conf)
    s = splat(grid, torch.cat([conf, ones, g_out], dim=1))
    w_splat, cnt, b = s[:, 0], s[:, 1], s[:, 2:]
    y0 = b / torch.clamp(cnt[:, None], min=1e-10)
    yg = _solve_system(grid, nm, w_splat, b, y0, params, blur)
    sliced = slice_(grid, yg)
    grad_target = sliced * conf
    grad_conf_map = slice_(grid, -yg * yhat) + sliced * target
    return grad_target, torch.sum(grad_conf_map, dim=1, keepdim=True)


# ---------------------------------------------------------------------------
# The differentiable solve
# ---------------------------------------------------------------------------


def _grid_of(feature, params: BSParams) -> BilateralGrid:
    return build_grid(feature * 255.0, params.sigma_spatial,
                      params.sigma_luma, params.sigma_chroma)


class _BilateralSolve(torch.autograd.Function):
    """The images of a batch are solved one by one, each on its own grid
    with its own per-channel CG scalars (the JAX package's ``vmap``).
    The forward keeps each image's grid, (n, m) and yhat for the
    backward, which is one gradient CG solve per image; the guide gets a
    zero gradient."""

    @staticmethod
    def forward(ctx, feature, target, conf, params: BSParams, blur):
        b, h, w, c = target.shape
        outs, saved = [], []
        for i in range(b):
            grid = _grid_of(feature[i], params)
            nm = bistochastize(grid, blur)
            xhat, yhat = _solve_image(grid, target[i].reshape(-1, c),
                                      conf[i].reshape(-1, 1), params, nm,
                                      blur)
            outs.append(xhat.reshape(h, w, c))
            saved.append((grid, nm, yhat))
        nvert = torch.tensor([g.nvert for g, _, _ in saved])
        ctx.mark_non_differentiable(nvert)
        ctx.save_for_backward(target, conf)
        ctx.saved, ctx.params, ctx.blur = saved, params, blur
        ctx.feature_shape = feature.shape
        return torch.stack(outs), nvert

    @staticmethod
    def backward(ctx, g_xhat, _g_nvert):
        target, conf = ctx.saved_tensors
        b, h, w, c = target.shape
        gts, gcs = [], []
        for i, (grid, nm, yhat) in enumerate(ctx.saved):
            gt, gc = _solve_image_grad(
                grid, nm, g_xhat[i].reshape(-1, c), conf[i].reshape(-1, 1),
                target[i].reshape(-1, c), yhat, ctx.params, ctx.blur)
            gts.append(gt.reshape(h, w, c))
            gcs.append(gc.reshape(h, w, 1))
        g_feature = (target.new_zeros(ctx.feature_shape)
                     if ctx.needs_input_grad[0] else None)
        return g_feature, torch.stack(gts), torch.stack(gcs), None, None


def bilateral_solve_stats(feature, target, conf, params: BSParams,
                          use_kernels: bool = True):
    """Differentiable bilateral solve, batched NHWC, and its grid stats.

    feature [B,H,W,3]: the guide of the grid (scaled by 255 inside, like
    BilateralLayer.py:52); target [B,H,W,C]: the signal to refine; conf
    [B,H,W,1]: per-pixel confidence.  Gradients flow to target and conf
    (the guide's is zero, as the reference's BilateralFunction returns
    None for it).  ``use_kernels``: blur with :func:`bilateral_blur`
    (the CUDA kernel on CUDA tensors) or :func:`bilateral_blur_plain`.

    A forward solve of one image blurs (1 + 10) + (1 + cg_maxiter)
    times, its gradient solve 1 + cg_maxiter times.  Returns (refined
    [B,H,W,C], {"nvert": [B] int64 vertex counts})."""
    blur = bilateral_blur if use_kernels else bilateral_blur_plain
    out, nvert = _BilateralSolve.apply(feature, target, conf, params, blur)
    return out, {"nvert": nvert}


def bilateral_solve(feature, target, conf, params: BSParams,
                    use_kernels: bool = True):
    """:func:`bilateral_solve_stats` without the stats."""
    return bilateral_solve_stats(feature, target, conf, params,
                                 use_kernels)[0]
