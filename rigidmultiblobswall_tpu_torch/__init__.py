"""PyTorch + CUDA port of rigidmultiblobswall_tpu for NVIDIA Hopper.

Counterpart of the JAX package rigidmultiblobswall_tpu, which stays the
reference: rigid multiblob bodies above a no-slip wall, stepped by
Brownian-dynamics schemes on the direct pairwise mobility engine. The
layout mirrors the JAX package (ops/, models/, io/, cli.py) and each
module names its JAX counterpart. Hot pair sweeps run hand-written CUDA
kernels (csrc/, built at first use by ops/_build.py); CPU tensors take
their plain PyTorch versions.

TF32 is switched off for the whole process: products that feed the
mobility lose about three digits in TF32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
