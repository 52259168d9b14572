"""evflow_tpu_torch: the PyTorch/CUDA port of evflow-tpu.

The JAX package `evflow_tpu` is the reference; this package mirrors its
module names (`ops/`, `models/`) so each function has an obvious
counterpart. Plain tensor code is PyTorch; the TPU's Pallas kernels on the
main path are hand-written CUDA C++ for sm_90a under `csrc/`, built with
nvcc at first use (`kernels.py`). Every kernel wrapper takes its plain
PyTorch version for CPU tensors, so the CPU tests run the same code paths.

The port imports nothing of the JAX package: it keeps its own copies of the
framework-free parts, `config` (plain dataclasses) and `io` (numpy), which
tests/test_torch_isolation.py holds equal to the JAX package's. Its entry
points (`init_state`, `init_corner_state`, the pipelines, `init_sae`,
`fidelity.corner_agreement`, the CLI `python -m evflow_tpu_torch.run`) run
on the card (`device="cuda"`) unless the caller passes `device="cpu"`;
with no card a default call raises.
"""

import torch

from . import config, io
from .config import DEFAULT, EngineConfig

# Geometry and cluster statistics are true fp32: no plain version (or any
# matmul of the port) may run in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["config", "io", "DEFAULT", "EngineConfig"]
