"""bundlefusion_tpu_torch — the PyTorch + CUDA port of ``bundlefusion_tpu``.

Same subpackages and module names as the JAX package, so each module's
counterpart sits at the same path:

  * ``geometry`` — SE(3)/SO(3), camera model, Kabsch.
  * ``io``       — frame wire format, synthetic scene renderer.
  * ``ops``      — frame preprocessing (carries the fused preprocess kernel).
  * ``features`` — batched SIFT, descriptor matching, correspondence filters.
  * ``solver``   — sparse+dense Gauss-Newton bundle adjustment with PCG.
  * ``bundle``   — chunk/keyframe hierarchy, trajectories, the pipeline.
  * ``fusion``   — dense-block TSDF integrate/de-integrate (carries the
    TSDF integrate kernel).
  * ``eval``     — ATE.

The hand-written CUDA kernels live in ``csrc/`` and are built with nvcc on
first use (``kernels.py``). Every kernel wrapper runs the kernel for CUDA
tensors and its plain PyTorch twin for CPU tensors.
"""

__version__ = "0.1.0"

import torch as _torch

# The JAX package makes full-f32 matmuls the floor
# (jax_default_matmul_precision=float32); TF32 keeps ~3 decimal digits, which
# the geometry and solver math cannot afford. bf16 is opted into explicitly
# where the reference chooses it (features/matcher.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import AppConfig, BundlingConfig, Config, tiny_test_config  # noqa: E402,F401
