"""PyTorch + CUDA port of the inverse-rendering framework for indoor scenes.

A second package beside ``inverserenderingofindoorscene_tpu`` (the JAX
reference, which stays as it is).  The module layout mirrors the JAX
package so each counterpart is found under the same path; inside, the code
is PyTorch idiom: ``nn.Module``s in NCHW, plain functions on tensors, an
explicit ``device`` and an explicit ``torch.Generator`` for init.

The public serving functions (``pipeline.inference``) and the kernel
wrapper ``ops.sg_render.render_sg_env`` keep the JAX package's NHWC
layout at their boundary.  The SG decode + shading integral runs through
a hand-written CUDA kernel for Hopper (``ops/csrc/sg_render_env.cu``) on CUDA tensors and
through its plain PyTorch version on CPU tensors.

This package imports ``torch`` and numpy, never ``jax`` and nothing of the
JAX package.
"""

__version__ = "0.1.0"
