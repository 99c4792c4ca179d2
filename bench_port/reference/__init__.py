"""The benchmark's plain reference: the inverse-rendering chain and its
training steps in plain PyTorch, float32 (the serving chain's shading in
float64), with no kernel, no cache and no batching tricks.

Frozen copies of the plain routes of the measured package: MGNet and
LightNet, the confidence CNN, the SG decode and hemisphere shading, the
scale fits, the cascade-1 input, the bilateral grid and its solve, the
masked losses and Adam.  They follow the published model (Li et al., CVPR
2020, github.com/lzqsd/InverseRenderingOfIndoorScene: ``models.py``,
``BilateralLayer.py``, ``trainBRDF.py``, ``trainLight.py``,
``testReal.py``).  This package imports ``torch`` and ``numpy`` only:
nothing of the measured package, nothing of JAX, so that a later change
to the program cannot move the yardstick.

``conv`` arguments: every convolution of the nets goes through one
function ``conv(x, weight, bias, stride, padding)``; :data:`CONV_F32` is
the plain one, :data:`CONV_BF16` casts as a bfloat16 configuration states,
and the benchmark's control passes a lower-precision one
(``reference.precision``).
"""
