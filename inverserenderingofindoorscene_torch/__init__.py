"""PyTorch + CUDA port of the inverse-rendering framework for indoor scenes.

A second package beside ``inverserenderingofindoorscene_tpu`` (the JAX
reference, which stays as it is).  The module layout mirrors the JAX
package so each counterpart is found under the same path; inside, the code
is PyTorch idiom: ``nn.Module``s in NCHW, plain functions on tensors, an
explicit ``device`` and an explicit ``torch.Generator`` for init.

The public serving and training functions (``pipeline.inference``,
``pipeline.light.light_step``, ``train.steps``) and the kernel wrappers
of ``ops.sg_render`` keep the JAX package's NHWC layout at their
boundary.  The SG decode and the shading integral run through
hand-written CUDA kernels for Hopper (``ops/csrc/*.cu``: the serving
kernel and the forward/backward pairs of training) on CUDA tensors and
through their plain PyTorch versions on CPU tensors.

This package imports ``torch`` and numpy, never ``jax`` and nothing of the
JAX package.
"""

__version__ = "0.1.0"
