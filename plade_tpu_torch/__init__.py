"""PLADE registration core on PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper.

A port of ``plade_tpu`` (JAX on a TPU), which stays the reference: module
paths and function names mirror it, so each counterpart is easy to find.
This package imports ``torch`` and never ``jax``.

Precision: the pipeline's geometric decisions (spacing-scale distances,
cos 5 deg angle tests) sit far below TF32 resolution, so importing the
package pins full float32 in matrix products and convolutions, mirroring
``plade_tpu``'s ``jax_default_matmul_precision = "highest"``.
"""
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
