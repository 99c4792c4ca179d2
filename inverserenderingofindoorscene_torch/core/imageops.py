"""Image-space ops on NCHW tensors, and the NHWC <-> NCHW views.

PyTorch's own ops already have the semantics that the JAX package's
``core/imageops.py`` rebuilds for the TPU: bilinear resize with
half-pixel centers (antialiased where it shrinks, as
``jax.image.resize(..., "linear")``), adaptive average pooling with the
torch bin rule, and edge-replicate padding.  The TPU speed workarounds there (the depthwise-conv
2x upsample, the hand-written pad VJP, the pooling matrices) are not
ported.

Each of the three ops runs its forward as the kernel that ``F``
calls (``F.interpolate``'s ``upsample_bilinear2d`` or its antialiased
twin, ``F.adaptive_avg_pool2d``, ``F.pad(mode="replicate")``'s
``replication_pad2d``), so its outputs are that call's bit for bit.
Where a gradient is taken, its backward is the op's adjoint written
without atomics: the CUDA backwards of those kernels add with atomics,
in another order on every run.  Under
``torch.use_deterministic_algorithms`` ``F.interpolate`` and ``F.pad``
switch on CUDA to slow decompositions (many small ops, backward by
``index_put``); calling the kernels keeps that mode's outputs the
default mode's, and its speed.  Resize and pool are separable linear
maps ``y = A x Bᵀ`` on the two spatial dims, so the adjoint is ``Aᵀ g B``
with the matrices made by the forward on an identity basis (the same
weights, antialiasing included), once per shape; the pad's adjoint
folds each border strip back onto its edge row or column.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (the nets' layout)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (the layout at the public functions)."""
    return x.permute(0, 2, 3, 1)


def _resize(x, out_hw, antialias):
    """``F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False,
    antialias=antialias)``'s kernel."""
    op = (torch.ops.aten._upsample_bilinear2d_aa if antialias
          else torch.ops.aten.upsample_bilinear2d)
    return op.vec(x, list(out_hw), False, None)


def _pool(x, out_hw, antialias):
    return F.adaptive_avg_pool2d(x, out_hw)


_SEPARABLE = {"resize": _resize, "pool": _pool}


@functools.lru_cache(maxsize=None)
def _axis_matrix(kind, axis, n_in, n_out, antialias, dtype, device):
    """[n_in, n_out]: the transpose of op ``kind``'s weights along spatial
    ``axis`` (0: H, 1: W), made by the op on the identity basis of that
    axis with the other axis 2 -> 2, whose weights are the identity.  (At
    1 -> 1 the CPU's antialiased resize takes other weights on the
    basis's axis than on a real image.)"""
    eye = torch.eye(n_in, dtype=dtype, device=device)
    if axis == 0:
        basis, size = eye.reshape(n_in, 1, n_in, 1).expand(-1, -1, -1, 2), (
            n_out, 2)
    else:
        basis, size = eye.reshape(n_in, 1, 1, n_in).expand(-1, -1, 2, -1), (
            2, n_out)
    with torch.no_grad():
        out = _SEPARABLE[kind](basis.contiguous(), size, antialias)
    return out[:, 0, :, 0] if axis == 0 else out[:, 0, 0, :]


class _Separable(torch.autograd.Function):
    """``_SEPARABLE[kind]`` forward; backward ``Aᵀ g B`` by two matmuls,
    in at least float32 (a bf16 gradient is computed in float32 and
    returned in bf16)."""

    @staticmethod
    def forward(ctx, x, kind, out_hw, antialias):
        ctx.key = (kind, tuple(x.shape[-2:]), out_hw, antialias)
        return _SEPARABLE[kind](x, out_hw, antialias)

    @staticmethod
    def backward(ctx, g):
        kind, (h, w), (oh, ow), antialias = ctx.key
        dtype = torch.promote_types(g.dtype, torch.float32)
        a_t = _axis_matrix(kind, 0, h, oh, antialias, dtype, g.device)
        b = _axis_matrix(kind, 1, w, ow, antialias, dtype, g.device).t()
        gx = torch.matmul(torch.matmul(a_t, g.to(dtype)), b)
        return gx.to(g.dtype), None, None, None


def _fold_edges(g: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """The adjoint of an edge-replicate pad of ``pad`` along ``dim``: the
    inner part, with each border strip's sum added to its edge."""
    n = g.shape[dim] - 2 * pad
    out = g.narrow(dim, pad, n).clone()
    out.narrow(dim, 0, 1).add_(g.narrow(dim, 0, pad).sum(dim, keepdim=True))
    out.narrow(dim, n - 1, 1).add_(
        g.narrow(dim, pad + n, pad).sum(dim, keepdim=True))
    return out


def _replicate(x, pad):
    """``F.pad(x, (pad,) * 4, mode="replicate")``'s kernel."""
    return torch.ops.aten.replication_pad2d(x, [pad] * 4)


class _ReplicationPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pad):
        ctx.pad = pad
        return _replicate(x, pad)

    @staticmethod
    def backward(ctx, g):
        return _fold_edges(_fold_edges(g, ctx.pad, -2), ctx.pad, -1), None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _separable(kind, x, out_hw, antialias=False):
    if _needs_grad(x):
        return _Separable.apply(x, kind, out_hw, antialias)
    return _SEPARABLE[kind](x, out_hw, antialias)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of NCHW to (H', W') with half-pixel centers, the
    JAX package's ``resize_bilinear``.  Where either side shrinks, the
    filter widens by the shrink factor on that side (antialiasing, as
    ``jax.image.resize`` does); an upscale or identity takes the plain
    bilinear kernel, which is the same function there."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    shrinks = oh < x.shape[-2] or ow < x.shape[-1]
    return _separable("resize", x, (oh, ow), shrinks)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``F.adaptive_avg_pool2d`` on NCHW (identity at equal size)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if x.shape[-2:] == (oh, ow):
        return x
    return _separable("pool", x, (oh, ow))


def replication_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Edge-replicate pad the two spatial dims of an NCHW tensor."""
    if _needs_grad(x):
        return _ReplicationPad.apply(x, pad)
    return _replicate(x, pad)
