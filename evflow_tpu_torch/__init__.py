"""evflow_tpu_torch: the PyTorch/CUDA port of evflow-tpu.

The JAX package `evflow_tpu` is the reference; this package mirrors its
module names (`ops/`, `models/`) so each function has an obvious
counterpart. Plain tensor code is PyTorch; the TPU's Pallas kernels on the
main path are hand-written CUDA C++ for sm_90a under `csrc/`, built with
nvcc at first use (`kernels.py`). Every kernel wrapper takes its plain
PyTorch version for CPU tensors, so the CPU tests run the same code paths.

The framework-free parts of the JAX package are shared, not copied:
`config` (plain dataclasses) and `io` (numpy). Importing `evflow_tpu`
loads no JAX, and nothing here imports `jax`.
"""

import torch

from evflow_tpu import config, io
from evflow_tpu.config import DEFAULT, EngineConfig

# Geometry and cluster statistics are true fp32: no plain version (or any
# matmul of the port) may run in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["config", "io", "DEFAULT", "EngineConfig"]
